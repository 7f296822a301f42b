"""The ``write_tracking_csv`` span's share of the traced commands' wall
time (host clock)."""


def read(ctx):
    s = ctx.spans.total("write_tracking_csv")
    return 100.0 * s / ctx.trace.window_s if s > 0.0 else None
