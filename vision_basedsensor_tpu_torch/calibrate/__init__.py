from vision_basedsensor_tpu_torch.calibrate.artifact import CalibrationArtifact
from vision_basedsensor_tpu_torch.calibrate.homography import fit_homography
from vision_basedsensor_tpu_torch.calibrate.pnp import (PnPResult,
                                                        solve_pnp_ransac)
from vision_basedsensor_tpu_torch.calibrate.zhang import (ZhangResult,
                                                          calibrate_intrinsics)

__all__ = ["fit_homography", "ZhangResult", "calibrate_intrinsics",
           "PnPResult", "solve_pnp_ransac", "CalibrationArtifact"]
