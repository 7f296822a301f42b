from vision_basedsensor_tpu_torch.detect.detector import (
    Detections,
    detect_markers,
    detect_markers_and_scale,
)

__all__ = ["Detections", "detect_markers", "detect_markers_and_scale"]
