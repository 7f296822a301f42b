"""Device milliseconds a batch of the activities launched inside the
program's ``vbs.detect.peak_field`` span: the unfused branch's windowed max
field of the NCC and its threshold, the first step of ``find_peaks``."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.device_s(ctx.trace, "vbs.detect.peak_field")
    return 1e3 * s / ctx.units if s else None
