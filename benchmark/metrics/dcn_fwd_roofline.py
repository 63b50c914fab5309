"""dcn_fwd_roofline.infer: the 16 DCNv2 nodes' least bf16 forward time at
the batch's shapes (roofline.forward_bound_ms) over the device time of
the dcn_fwd kernels (with their split-K reduction), per forward."""
from benchmark import roofline


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(("dcn_fwd",))
    if ms <= 0:
        return None
    batch = ctx.cell["traffic"]["batch"]
    forwards = ctx.units / batch
    return 100.0 * roofline.forward_bound_ms(batch) * forwards / ms
