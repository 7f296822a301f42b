from vision_basedsensor_tpu_torch.parallel.ingest import ShardedPackedFeed
from vision_basedsensor_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedFrames,
    make_mesh,
    make_sharded_pipeline,
    shard_frames,
)

__all__ = ["Mesh", "ShardedFrames", "ShardedPackedFeed", "make_mesh",
           "make_sharded_pipeline", "shard_frames"]
