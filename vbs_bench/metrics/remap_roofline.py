"""The remap's share of its roofline: the frozen least time
(``calibrated_bound.py:remap_bound_s``) of every frame the traced sessions
rectified, a chunk's frames a call and frame 0 once more a session in
``initialize``, over the device time launched inside the program's
``vbs.undistort.remap`` span."""
from vbs_bench import program_spans, roofline
from vbs_bench.calibrated_bound import remap_bound_s


def read(ctx):
    s = program_spans.device_s(ctx.trace, "vbs.undistort.remap")
    if not s:
        return None
    t, c = ctx.traffic, ctx.conf
    calls = ctx.units * (t["frames"] // t["chunk"] + 1)
    frames = ctx.units * (t["frames"] + 1)
    return roofline.share_pct(
        remap_bound_s(frames, calls, c["height"], c["width"]), s)
