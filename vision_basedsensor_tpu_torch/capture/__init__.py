from vision_basedsensor_tpu_torch.capture.server import (
    CameraHandler,
    LedRing,
    StreamingServer,
    run_server,
)

__all__ = ["CameraHandler", "LedRing", "StreamingServer", "run_server"]
