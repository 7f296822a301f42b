from vision_basedsensor_tpu_torch.utils.profiling import StageTimer, trace_annotation
from vision_basedsensor_tpu_torch.utils.log import get_logger

__all__ = ["StageTimer", "trace_annotation", "get_logger"]
