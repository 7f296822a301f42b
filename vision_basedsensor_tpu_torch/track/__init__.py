from vision_basedsensor_tpu_torch.track.associate import TrackedFrames, associate
from vision_basedsensor_tpu_torch.track.rings import (ReferenceMarkers,
                                                      assign_identities,
                                                      kmeans_1d)

__all__ = ["ReferenceMarkers", "assign_identities", "kmeans_1d",
           "TrackedFrames", "associate"]
