"""conv_ms_per_image.train: device ms of the convolution kernels
(forward, dgrad, wgrad) a trained image, over the traced sub-window."""


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(kind="convolution")
    return ms / (ctx.units * ctx.cell["traffic"]["batch"]) if ms > 0 else None
