"""Milliseconds a batch in which the device was idle while the main thread
was inside the program's ``vbs.contact`` span (contact state: the dome
layout's start points, the plane fit)."""
from vbs_bench import program_spans


def read(ctx):
    s = program_spans.idle_s(ctx.trace, "vbs.contact")
    return None if s is None else 1e3 * s / ctx.units
