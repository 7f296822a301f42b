from vision_basedsensor_tpu_torch.analysis.force import (ContactState,
                                                         contact_state_sequence,
                                                         start_end_displacement)
from vision_basedsensor_tpu_torch.analysis.series import displacement_statistics

__all__ = ["ContactState", "contact_state_sequence", "start_end_displacement",
           "displacement_statistics"]
