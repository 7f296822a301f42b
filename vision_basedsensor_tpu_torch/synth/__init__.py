from vision_basedsensor_tpu_torch.synth.render import (DomeScene, default_scene,
                                                       indentation_staircase,
                                                       render_frames,
                                                       tilt_deviation_field)

__all__ = ["DomeScene", "default_scene", "indentation_staircase",
           "render_frames", "tilt_deviation_field"]
