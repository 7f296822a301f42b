"""The sequential association kernel's (``csrc/associate.cu``) share of its
roofline: the chain bound of a chunk's frames
(``calibrated_bound.py:associate_bound_s``) over the profiler's mean device
time of one ``associate_kernel``."""
from vbs_bench import roofline
from vbs_bench.calibrated_bound import associate_bound_s


def read(ctx):
    times = ctx.trace.durations_s(lambda n: "associate_kernel" in n)
    if not times:
        return None
    return roofline.share_pct(associate_bound_s(ctx.traffic["chunk"]),
                              sum(times) / len(times))
