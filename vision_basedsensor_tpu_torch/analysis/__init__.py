from vision_basedsensor_tpu_torch.analysis.force import (ContactState,
                                                         contact_state_sequence)

__all__ = ["ContactState", "contact_state_sequence"]
