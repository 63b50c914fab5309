"""dcn_bwd_roofline.train: the 16 DCNv2 nodes' least f32 backward time at
the batch's shapes (roofline.backward_bound_ms) over the device time of
the dcn_bwd kernels (data, weight and the dW reduction), per step."""
from benchmark import roofline


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(("dcn_bwd",))
    if ms <= 0:
        return None
    return (100.0 * roofline.backward_bound_ms(ctx.cell["traffic"]["batch"])
            * ctx.units / ms)
