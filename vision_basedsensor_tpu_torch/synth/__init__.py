from vision_basedsensor_tpu_torch.synth.degrade import (defocus,
                                                        illumination_gradient,
                                                        motion_blur,
                                                        sensor_noise, vignette)
from vision_basedsensor_tpu_torch.synth.render import (
    DomeScene, default_scene, indentation_staircase,
    membrane_indentation_field, probe_indentation_field, render_frames,
    tilt_deviation_field)

__all__ = ["DomeScene", "default_scene", "render_frames",
           "indentation_staircase", "membrane_indentation_field",
           "probe_indentation_field", "tilt_deviation_field",
           "defocus", "illumination_gradient", "motion_blur",
           "sensor_noise", "vignette"]
