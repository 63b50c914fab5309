"""Plain modulated deformable convolution (DCNv2), 3x3, stride 1, one
deformable group, and its module.

Layout: x (B, H, W, Cin), offsets (B, H, W, 18) tap-major interleaved
(dy, dx) over the row-major taps, masks (B, H, W, 9) after the sigmoid,
weights (3, 3, Cin, Cout).  Each tap samples x bilinearly at (y + ky + dy,
x + kx + dx), zero outside the image.  With `max_offset_y=R` the
y-offsets are clamped to [-R, R] first (the `rowband:R` inference mode);
without it the offsets are used as they are (the exact mode).

Under autograd the sampling is recomputed in the backward pass
(torch.utils.checkpoint), so a batch of 16 at 512x1024 keeps only each
node's inputs."""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import BatchNorm2d


def deform_conv2d(x, offsets, masks, weights, bias=None, max_offset_y=None):
    """out (B, H, W, Cout) = sum over taps and channels of the masked
    bilinear samples times the weights, plus the bias."""
    if max_offset_y is not None:
        r = float(max_offset_y)
        oy = offsets[..., 0::2].clamp(-r, r)
        offsets = torch.stack([oy, offsets[..., 1::2]], -1).flatten(-2)
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    dev = x.device
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ky = torch.arange(-1, 2, dtype=torch.float32,
                      device=dev).repeat_interleave(3)
    kx = torch.arange(-1, 2, dtype=torch.float32, device=dev).repeat(3)
    off = offsets.reshape(b, h, w, 9, 2).float()
    sy = gy[None, :, :, None] + ky + off[..., 0]
    sx = gx[None, :, :, None] + kx + off[..., 1]
    y0 = torch.floor(sy).detach()
    x0 = torch.floor(sx).detach()
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]
    y0 = y0.long()
    x0 = x0.long()
    bidx = torch.arange(b, device=dev)[:, None, None, None] * (h * w)
    xf = x.reshape(b * h * w, cin)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = xf[bidx + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(inside[..., None], v, 0)

    sampled = (tap(y0, x0) * (1 - fy) * (1 - fx)
               + tap(y0, x0 + 1) * (1 - fy) * fx
               + tap(y0 + 1, x0) * fy * (1 - fx)
               + tap(y0 + 1, x0 + 1) * fy * fx)
    sampled = (sampled * masks[..., None]).to(x.dtype)
    out = torch.einsum("bhwkc,kco->bhwo", sampled,
                       weights.reshape(9, cin, cout).to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def dcn_flops(h: int, w: int, cin: int, cout: int, batch: int = 1) -> float:
    """Operations of one node's product: 2 * pixels * 9 * Cin * Cout."""
    return 2.0 * batch * h * w * 9 * cin * cout


class DCNv2(nn.Module):
    """Offset/mask conv + deformable sampling + contraction, with the
    parameter names of CenterPoly's DCN (`weight` (Cout, Cin, 3, 3),
    `bias`, `conv_offset_mask` with 18 interleaved offsets then 9 mask
    logits).  On the meta device (the operation count of roofline.py) it
    returns an empty output of the right shape and records its product's
    operations in `flops`."""

    def __init__(self, in_channels: int, out_channels: int,
                 max_offset_y: int | None = None):
        super().__init__()
        self.max_offset_y = max_offset_y
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset_mask = nn.Conv2d(in_channels, 27, 3, padding=1)
        self.flops = 0.0

    def forward(self, x):
        om = self.conv_offset_mask(x)
        b, cin, h, w = x.shape
        cout = self.weight.shape[0]
        if x.device.type == "meta":
            self.flops += dcn_flops(h, w, cin, cout, b)
            return x.new_empty(b, cout, h, w)
        om = om.permute(0, 2, 3, 1).float()
        offsets = om[..., :18].contiguous()
        masks = torch.sigmoid(om[..., 18:]).contiguous()
        args = (x.permute(0, 2, 3, 1).contiguous(), offsets, masks,
                self.weight.permute(2, 3, 1, 0).contiguous(), self.bias)
        if torch.is_grad_enabled():
            out = checkpoint(deform_conv2d, *args, self.max_offset_y,
                             use_reentrant=False)
        else:
            out = deform_conv2d(*args, self.max_offset_y)
        return out.permute(0, 3, 1, 2)


class DeformConvBlock(nn.Module):
    """DCNv2 -> BN -> ReLU (CenterPoly's DeformConv: `conv`, `actf`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 max_offset_y: int | None = None):
        super().__init__()
        self.conv = DCNv2(in_channels, out_channels, max_offset_y)
        self.actf = nn.Sequential(BatchNorm2d(out_channels),
                                  nn.ReLU(inplace=True))

    def forward(self, x):
        return self.actf(self.conv(x))
