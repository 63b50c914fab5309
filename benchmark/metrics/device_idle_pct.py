"""device_idle_pct.*: the share of the traced sub-window in which no
kernel, copy or set runs on the device (the union of their intervals)."""


def read(ctx):
    if not ctx.trace.kernels or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
