"""Calibration artifacts. Only the typed artifact is ported (its JSON and
XLSX forms); the Zhang, PnP and chessboard solvers are not."""
from vision_basedsensor_tpu_torch.calibrate.artifact import CalibrationArtifact

__all__ = ["CalibrationArtifact"]
