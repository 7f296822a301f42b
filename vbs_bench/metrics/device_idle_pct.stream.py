"""The device's idle share of the traced window: 100 minus the union of
the device activities' spans (kernels, copies, fills) over the window."""


def read(ctx):
    return ctx.trace.idle_pct()
