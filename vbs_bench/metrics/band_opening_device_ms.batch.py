"""Device milliseconds a batch of the activities launched inside the
program's ``vbs.detect.band_opening`` span: the unfused branch's boundary
band and 5x5 opening (min and max filters)."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.device_s(ctx.trace, "vbs.detect.band_opening")
    return 1e3 * s / ctx.units if s else None
