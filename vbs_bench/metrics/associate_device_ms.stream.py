"""Device milliseconds a chunk of the activities launched inside the
program's ``vbs.track.associate`` span (``pipeline.py:_associate``: in
sequential mode one launch of the association kernel, ``csrc/associate.cu``,
over the chunk's frames)."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.device_s(ctx.trace, "vbs.track.associate")
    t = ctx.traffic
    return 1e3 * s / (ctx.units * (t["frames"] // t["chunk"])) if s else None
