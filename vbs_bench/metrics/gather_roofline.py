"""The window gather's (K3/K4, ``csrc/gather.cu``) share of its roofline:
the frozen least time (``roofline.gather_bound_s``, the distinct window
pixels counted on the reference's own windows of the batch) over the
profiler's mean device time of one ``gather_windows_kernel``."""
from vbs_bench import roofline


def read(ctx):
    times = ctx.trace.durations_s(lambda n: "gather_windows_kernel" in n)
    batch = [s for s in ctx.stats if s["frames"] == ctx.traffic["batch"]]
    if not times or not batch:
        return None
    s = batch[-1]
    bound = roofline.gather_bound_s(s["frames"], s["peaks"], s["patch"],
                                    s["pack"], s["window_pixels"])
    return roofline.share_pct(bound, sum(times) / len(times))
