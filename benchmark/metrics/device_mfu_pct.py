"""device_mfu_pct.infer: the whole forward's share of the card's peak at
the configuration's precision while the device is busy: the operations
of one eval-mode forward of a frame (roofline.forward_flops) x the
traced sub-window's frames, over its busy time (the union of kernel
intervals).  It moves with infer_device_ms_per_frame and bounds each
kernel's roofline share there."""
from benchmark import roofline
from benchmark.harness import cells


def read(ctx):
    conf = ctx.cell["config"]
    if not ctx.trace.kernels or ctx.trace.busy_s <= 0:
        return None
    flops = sum(roofline.forward_flops(conf, conf["input_h"],
                                       conf["input_w"], False).values())
    return (100.0 * flops * ctx.units
            / (ctx.trace.busy_s
               * cells.module("metrics", "mfu_pct").peak(conf[ctx.mode])))
