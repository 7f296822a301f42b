"""Device milliseconds a batch of the activities launched inside the
``detect_markers`` span (by the launch call's correlation)."""


def read(ctx):
    s = ctx.trace.device_s_inside("detect_markers")
    return 1e3 * s / ctx.units if s > 0.0 else None
