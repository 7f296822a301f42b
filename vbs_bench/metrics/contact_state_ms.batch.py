"""Device milliseconds a batch of the activities launched inside the
``contact_state_sequence`` span (by the launch call's correlation)."""


def read(ctx):
    s = ctx.trace.device_s_inside("contact_state_sequence")
    return 1e3 * s / ctx.units if s > 0.0 else None
