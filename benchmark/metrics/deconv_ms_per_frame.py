"""deconv_ms_per_frame.infer: device ms a served frame of the dense
transposed convolutions of resdcn's three up stages, over the traced
sub-window: the kernels whose names hold "dgrad" (cuDNN runs a no-grad
transposed convolution as its data-gradient kernel; a no-grad resdcn_101
frame runs no other)."""

WORDS = ("dgrad",)


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(WORDS)
    return ms / ctx.units if ms > 0 else None
