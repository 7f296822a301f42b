from vision_basedsensor_tpu_torch.analysis.force import (ContactState,
                                                         DeviationAnalysis,
                                                         analyze_deviation,
                                                         contact_state_sequence,
                                                         deviation_field,
                                                         start_end_displacement)
from vision_basedsensor_tpu_torch.analysis.series import displacement_statistics

__all__ = ["ContactState", "DeviationAnalysis", "analyze_deviation",
           "contact_state_sequence", "deviation_field",
           "start_end_displacement", "displacement_statistics"]
