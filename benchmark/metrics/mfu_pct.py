"""mfu_pct.*: the whole step's share of the card's peak at the
configuration's precision, from the unprofiled window's rate (the
metric's `moves`): serving, the operations of one eval-mode forward of a
frame (roofline.forward_flops) x frames/s; training, 3 x those of a
train-mode forward of an image x images/s.  Peaks: bf16, TF32 (f32 with
TF32 on) or f32 outside the tensor cores (f32 with TF32 off)."""
from benchmark import roofline


def peak(part: dict) -> float:
    if part["precision"] == "bfloat16":
        return roofline.PEAK_BF16_FLOPS
    return (roofline.PEAK_TF32_FLOPS if part.get("tf32")
            else roofline.PEAK_F32_FLOPS)


def read(ctx):
    conf = ctx.cell["config"]
    train = ctx.mode == "train"
    flops = sum(roofline.forward_flops(conf, conf["input_h"],
                                       conf["input_w"], train).values())
    passes = 3 if train else 1
    return (100.0 * passes * flops * ctx.e2e[ctx.metric["moves"]]
            / peak(conf[ctx.mode]))
