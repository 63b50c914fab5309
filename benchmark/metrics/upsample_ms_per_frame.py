"""upsample_ms_per_frame.infer: device ms of the IDA up-sampler a served
frame, over the traced sub-window: the kernels whose names hold "dgrad"
(cuDNN runs a no-grad transposed convolution as its data-gradient kernel;
DLA-34's only ones are its 8 depthwise up-samplers) or "ida_upsample_add"
(the port's own up-sampler kernel, the skip's add fused)."""

WORDS = ("dgrad", "ida_upsample_add")


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(WORDS)
    return ms / ctx.units if ms > 0 else None
