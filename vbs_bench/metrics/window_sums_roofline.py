"""The window-sums kernel's (K5, ``csrc/window_sums.cu``, three-field mode)
share of its roofline: the frozen least time of a batch's window sums
(``window_sums_bound.py``, on the gated pixels that the reference counts
over the batch's own peaks) over the profiler's mean device time of one
``window_sums_kernel<false>``."""
from vbs_bench import roofline
from vbs_bench.window_sums_bound import window_sums_bound_s


def _fields_mode(name: str) -> bool:
    # Demangled or mangled: the packed mode is the template's ``true``.
    return ("window_sums_kernel<false>" in name
            or "window_sums_kernelILb0E" in name)


def read(ctx):
    times = ctx.trace.durations_s(_fields_mode)
    batch = [s for s in ctx.stats
             if "gated_visits" in s and s["frames"] == ctx.traffic["batch"]]
    if not times or not batch:
        return None
    s = batch[-1]
    bound = window_sums_bound_s(s["frames"] * s["peaks"], s["patch"],
                                s["soft_floor"], s["gated_visits"],
                                s["gated_pixels"])
    return roofline.share_pct(bound, sum(times) / len(times))
