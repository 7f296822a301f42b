"""The fields kernel's (K1/K2, ``csrc/fields.cu``) share of its roofline:
the frozen least time of a batch's fields (``roofline.fields_bound_s``)
over the profiler's mean device time of one ``fused_fields_kernel``."""
from vbs_bench import roofline
from vbs_bench.reference import config


def read(ctx):
    times = ctx.trace.durations_s(lambda n: "fused_fields_kernel" in n)
    if not times:
        return None
    cfg = config._from_jsonable(config.PipelineConfig,
                                ctx.conf["pipeline"])
    h, w = ctx.conf["height"], ctx.conf["width"]
    prof = cfg.detect_profile(h)
    bound = roofline.fields_bound_s(ctx.traffic["batch"], h, w,
                                    prof.band_window, prof.peak_window,
                                    cfg.detect.open_ksize)
    return roofline.share_pct(bound, sum(times) / len(times))
