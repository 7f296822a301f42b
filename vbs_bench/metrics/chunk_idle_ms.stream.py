"""Milliseconds a chunk in which the device was idle while the main thread
was inside the program's ``vbs.pipeline.chunk`` span
(``StreamingPipeline.process``: the host launching a chunk's work)."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.idle_s(ctx.trace, "vbs.pipeline.chunk")
    if s is None:
        return None
    t = ctx.traffic
    return 1e3 * s / (ctx.units * (t["frames"] // t["chunk"]))
