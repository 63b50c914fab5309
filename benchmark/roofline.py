"""The yardstick's counts: the H100's peaks, the DCNv2 kernels' least
times from their shapes, and the operations of a whole forward.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.  The DCN
bounds count each input byte read once and each output byte written
once, whatever the kernel reads again, and each product's operations
once."""
from __future__ import annotations

import torch
from torch import nn

PEAK_BF16_FLOPS = 989e12    # dense bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12    # dense TF32 on the tensor cores
PEAK_F32_FLOPS = 67e12      # f32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3

# (H, W, Cin, Cout) of DLA-34's 16 DCNv2 nodes at a 512x1024 input
# (stride 4 output), and how many nodes of each shape a forward runs
NODE_SHAPES = {(16, 32, 512, 256): 1, (32, 64, 256, 256): 1,
               (32, 64, 256, 128): 2, (64, 128, 128, 128): 2,
               (64, 128, 128, 64): 4, (32, 64, 256, 64): 1,
               (128, 256, 64, 64): 5}


def node_bound_ms(shape, batch: int = 1) -> float:
    """Least time of one bf16 forward of a node: operations (2 N 9 Cin
    Cout) over the bf16 peak against bytes (x, offsets, masks, W, b read
    once, the output written once) over HBM."""
    h, w, cin, cout = shape
    npix = batch * h * w
    flops = 2.0 * npix * 9 * cin * cout
    nbytes = (npix * cin * 2 + npix * 27 * 4 + 9 * cin * cout * 2
              + cout * 2 + npix * cout * 2)
    return 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def bwd_bytes(shape, batch: int) -> float:
    """Bytes of one f32 backward of a node: x, offsets, masks, W, b and g
    read once; dx, d offsets, d masks, dW and db written once."""
    h, w, cin, cout = shape
    npix = batch * h * w
    return 4.0 * (2 * (npix * cin + npix * 27 + 9 * cin * cout + cout)
                  + npix * cout)


def bwd_bound_tf32_ms(shape, batch: int) -> float:
    """Least time of one f32 backward of a node: the larger of its two
    products (4 N 9 Cin Cout operations) at the TF32 peak and its ~32
    elementwise operations per (pixel, tap, channel) at the f32 peak
    (the two units run at once), against `bwd_bytes` over HBM."""
    h, w, cin, cout = shape
    npix = batch * h * w
    t_mma = 4.0 * npix * 9 * cin * cout / PEAK_TF32_FLOPS
    t_elt = 32.0 * npix * 9 * cin / PEAK_F32_FLOPS
    return 1e3 * max(t_mma, t_elt, bwd_bytes(shape, batch) / PEAK_BYTES)


def forward_bound_ms(batch: int) -> float:
    """The 16 nodes' least forward time (bf16) for a batch."""
    return sum(n * node_bound_ms(s, batch) for s, n in NODE_SHAPES.items())


def backward_bound_ms(batch: int) -> float:
    """The 16 nodes' least backward time (f32) for a batch."""
    return sum(n * bwd_bound_tf32_ms(s, batch)
               for s, n in NODE_SHAPES.items())


def forward_flops(conf: dict, h: int, w: int,
                  training: bool = False) -> dict:
    """Operations of one forward of a configuration's reference network
    on one (h, w) image, from the shapes on the meta device, in eval
    mode or (with `training`; DLA-34 then also runs the 1x1 projections
    whose only output is their BatchNorm statistics) in train mode:
    {"conv": 2 x output elements x Cin / groups x kh x kw over
    nn.Conv2d, "deconv": 2 x input elements x Cout / groups x kh x kw
    over nn.ConvTranspose2d, "dcn": 2 x pixels x 9 x Cin x Cout over the
    DCNv2 products}."""
    from .reference import nets
    from .reference.dcn import DCNv2
    counts = {"conv": 0.0, "deconv": 0.0, "dcn": 0.0}

    def conv(mod, inp, out):
        counts["conv"] += (2.0 * out.numel() * mod.in_channels / mod.groups
                           * mod.kernel_size[0] * mod.kernel_size[1])

    def deconv(mod, inp, out):
        counts["deconv"] += (2.0 * inp[0].numel() * mod.out_channels
                             / mod.groups * mod.kernel_size[0]
                             * mod.kernel_size[1])

    with torch.device("meta"):
        model = nets.build(conf).train(training)
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose2d):
                m.register_forward_hook(deconv)
            elif isinstance(m, nn.Conv2d):
                m.register_forward_hook(conv)
        with torch.no_grad():
            model(torch.empty(1, 3, h, w))
    counts["dcn"] = sum(m.flops for m in model.modules()
                        if isinstance(m, DCNv2))
    return counts
