from vision_basedsensor_tpu_torch.utils.profiling import SPANS, trace_annotation
from vision_basedsensor_tpu_torch.utils.log import get_logger

__all__ = ["SPANS", "trace_annotation", "get_logger"]
