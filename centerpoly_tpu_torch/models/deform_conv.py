"""Modulated deformable convolution (DCNv2) layers.

Parameter names follow the reference's DCN (pose_dla_dcn.py:347-359 and
the DCNv2 extension): `weight` (Cout, Cin, 3, 3), `bias`, and
`conv_offset_mask` whose 27 output channels are 18 interleaved (dy, dx)
offsets then 9 mask logits.  The reference's `chunk(out, 3)` followed by
`cat(o1, o2)` is the same split, so a reference `.pth` loads as it is.

The sampling and contraction run in kernels/dcn.py: the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor, in the clamp mode that
`dcn_kernel` names (`parse_dcn_kernel`; the JAX package's
`_parse_bounded_mode`, `rowband_dcn_mode` and `halo_dcn_mode`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.dcn import deform_conv2d
from .layers import BatchNorm2d

# R when `dcn_kernel` says `rowband` or `halo` without one (the
# DEFAULT_MAX_OFFSET of kernels/dcn_rowband.py and kernels/dcn_halo.py)
DEFAULT_MAX_OFFSET = 4


def parse_dcn_kernel(mode: str) -> tuple[str, int | None]:
    """`dcn_kernel` vocabulary -> (clamp mode, R).

    auto | off | on (and 0 | 1): ("exact", None), exact DCNv2 semantics.
    rowband[:R]: ("rowband", R), y-offsets clamped to [-R, R], x exact.
    halo[:R]: ("halo", R), both offset axes clamped to [-R, R].
    R defaults to 4 and must be a non-negative integer.
    """
    prefix, _, spec = mode.lower().partition(":")
    if prefix in ("auto", "off", "on", "0", "1") and not spec:
        return "exact", None
    if prefix in ("rowband", "halo"):
        if not spec:
            return prefix, DEFAULT_MAX_OFFSET
        if not spec.isdigit():
            raise ValueError(f"dcn_kernel={mode!r}: R must be a "
                             f"non-negative integer")
        return prefix, int(spec)
    raise ValueError(f"dcn_kernel={mode!r}: expected auto | off | on | "
                     f"rowband[:R] | halo[:R]")


class DCNv2(nn.Module):
    """Offset/mask conv + deformable sampling + contraction.  3x3, stride
    1, dilation 1, one deformable group; the offset conv starts at zero
    (a plain conv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dcn_kernel: str = "auto"):
        super().__init__()
        mode, r = parse_dcn_kernel(dcn_kernel)
        # the kernels' clamp keywords (kernels/dcn.py::clamp_mode)
        self.clamp = ({"max_offset_y": r} if mode == "rowband" else
                      {"max_offset": r} if mode == "halo" else {})
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_normal_(self.weight, nonlinearity="relu")
        self.conv_offset_mask = nn.Conv2d(in_channels, 27, 3, padding=1)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)

    def forward(self, x):
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1).float()
        offsets = om[..., :18].contiguous()
        masks = torch.sigmoid(om[..., 18:]).contiguous()
        # raw offsets: the kernels own the clamp and its gradient rule
        # (clamping here too would compose rowband's 0.5 at the bound to
        # 0.25)
        out = deform_conv2d(
            x.permute(0, 2, 3, 1).contiguous(), offsets, masks,
            self.weight.permute(2, 3, 1, 0).to(x.dtype).contiguous(),
            self.bias.to(x.dtype), **self.clamp)
        return out.permute(0, 3, 1, 2)


class DeformConvBlock(nn.Module):
    """DCNv2 -> BN -> ReLU (reference DeformConv: `conv`, `actf`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dcn_kernel: str = "auto"):
        super().__init__()
        self.conv = DCNv2(in_channels, out_channels, dcn_kernel)
        self.actf = nn.Sequential(BatchNorm2d(out_channels),
                                  nn.ReLU(inplace=True))

    def forward(self, x):
        return self.actf(self.conv(x))
