"""The main thread's time inside the program's ``vbs.feed.wait`` span (the
feed waiting for its prefetch thread's entropy decode) as a share of the
traced window."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.host_s(ctx.trace, "vbs.feed.wait")
    return None if s is None else 100.0 * s / ctx.trace.window_s
