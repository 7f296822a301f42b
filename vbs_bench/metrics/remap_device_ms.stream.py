"""Device milliseconds a chunk of the activities launched inside the
program's ``vbs.undistort.remap`` span (``pipeline.py:_preprocess``: a
chunk's frames to float32 gray and their bilinear remap through the
rectify map; a session's one-frame remap of frame 0 in ``initialize``
counts in its session's chunks)."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.device_s(ctx.trace, "vbs.undistort.remap")
    t = ctx.traffic
    return 1e3 * s / (ctx.units * (t["frames"] // t["chunk"])) if s else None
