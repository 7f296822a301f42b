from vision_basedsensor_tpu_torch.reconstruct.depth import reconstruct_positions
from vision_basedsensor_tpu_torch.reconstruct.displacement import (
    Reconstruction,
    displacement_scan,
    reconstruct_sequence,
)

__all__ = ["reconstruct_positions", "displacement_scan",
           "reconstruct_sequence", "Reconstruction"]
