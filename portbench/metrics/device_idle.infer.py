"""device_idle.infer: share of the traced window in which no operation ran
on the device (the union of kernel, copy and set intervals), in %."""


def read(ctx):
    t = ctx.trace
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
