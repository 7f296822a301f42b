from vision_basedsensor_tpu_torch.synth.render import (DomeScene, default_scene,
                                                       render_frames)

__all__ = ["DomeScene", "default_scene", "render_frames"]
