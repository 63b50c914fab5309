"""conv_ms_per_frame.infer: device ms of the convolution kernels (cuDNN,
CUTLASS) a served frame, over the traced sub-window."""


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(kind="convolution")
    return ms / ctx.units if ms > 0 else None
