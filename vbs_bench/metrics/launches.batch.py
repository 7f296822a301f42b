"""Device activities (kernels, copies, fills) a batch launched inside the
program's ``vbs.pipeline.process_frames`` span."""
from vbs_bench import program_spans


def read(ctx):
    n = program_spans.launches(ctx.trace, "vbs.pipeline.process_frames")
    return n / ctx.units if n else None
