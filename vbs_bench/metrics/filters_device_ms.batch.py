"""Device milliseconds a batch of the activities launched inside the
program's ``vbs.detect.filters`` span: grayscale, the DoG area mask and the
NCC (filter GEMMs and their elementwise operations)."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.device_s(ctx.trace, "vbs.detect.filters")
    return 1e3 * s / ctx.units if s else None
