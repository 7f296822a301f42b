"""The main thread's time inside the program's ``vbs.stream.readback`` span
(a chunk's outputs copied to the host, which waits for the chunk's device
work) as a share of the traced window."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.host_s(ctx.trace, "vbs.stream.readback")
    return None if s is None else 100.0 * s / ctx.trace.window_s
