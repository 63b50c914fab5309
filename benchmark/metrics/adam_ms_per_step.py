"""adam_ms_per_step.train: device ms of Adam's multi-tensor kernels a
step, over the traced sub-window."""


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(kind="adam")
    return ms / ctx.units if ms > 0 else None
