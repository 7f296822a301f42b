"""Device milliseconds a batch of the activities launched inside the
program's ``vbs.detect.moments`` span: the moment sums of the gathered
windows."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.device_s(ctx.trace, "vbs.detect.moments")
    return 1e3 * s / ctx.units if s else None
