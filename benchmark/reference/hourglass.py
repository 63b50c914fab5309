"""Stacked hourglass backbone (CornerNet architecture), named as the
reference's torch modules.

Behavioral reference: src/lib/models/networks/large_hourglass.py.  pre = 7x7/s2
`convolution`(128) + stride-2 `residual`(256) (x4 down), then per stack a
5-level recursive hourglass (`kp_module`) with dims
(256, 256, 384, 384, 384, 512) and modules (2, 2, 2, 2, 2, 4), a 3x3
`convolution`(256), and per-stack heads; between stacks
relu(inters_(inter) + cnvs_(cnv)) -> inters.  Each level goes down by the
stride-2 first residual of `low1` (the reference's pooling is the
identity) and up by a nearest x2 upsample.  Module and parameter names
are the reference's, so its state_dict loads as it is.  Pure convolution:
no DCNv2 node, so `dcn_kernel` has nothing to act on.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .layers import BatchNorm2d

DIMS = (256, 256, 384, 384, 384, 512)
MODULES = (2, 2, 2, 2, 2, 4)
PRE_DIM = 256   # pre's output width and the cnv width, fixed in both packages


class Convolution(nn.Module):
    """The reference's `convolution`: conv (bias only without BN) -> BN ->
    ReLU, children `conv` and `bn`; symmetric padding k // 2 at every
    stride."""

    def __init__(self, k: int, in_channels: int, out_channels: int,
                 stride: int = 1, with_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, k, stride, k // 2,
                              bias=not with_bn)
        self.bn = BatchNorm2d(out_channels) if with_bn else nn.Identity()

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class HourglassResidual(nn.Module):
    """The reference's hourglass `residual`: conv1/bn1, conv2/bn2, and a
    1x1 `skip` (conv, BN) when the stride or the width changes."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride, 1,
                               bias=False)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, 1, 1,
                               bias=False)
        self.bn2 = BatchNorm2d(out_channels)
        if stride != 1 or in_channels != out_channels:
            self.skip = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, stride, bias=False),
                BatchNorm2d(out_channels))
        else:
            self.skip = nn.Identity()

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.skip(x))


def _residuals(widths: Sequence[int], stride: int = 1) -> nn.Sequential:
    """Residuals widths[0] -> widths[1] -> ...; the first one strided."""
    pairs = zip(widths, widths[1:])
    return nn.Sequential(*(HourglassResidual(a, b, stride if i == 0 else 1)
                           for i, (a, b) in enumerate(pairs)))


class HourglassLevel(nn.Module):
    """One recursion level (the reference's `kp_module`): up1 (curr_mod
    residuals) + up2(low3(low2(low1(x)))), low1 starting with a stride-2
    residual, low2 the next level or, at the deepest, next_mod residuals,
    low3 ending in curr_dim, up2 a nearest x2 upsample."""

    def __init__(self, in_channels: int, dims: Sequence[int],
                 modules: Sequence[int]):
        super().__init__()
        curr_dim, next_dim = dims[0], dims[1]
        curr_mod, next_mod = modules[0], modules[1]
        self.up1 = _residuals([in_channels] + [curr_dim] * curr_mod)
        self.low1 = _residuals([in_channels] + [next_dim] * curr_mod, 2)
        if len(dims) > 2:
            self.low2 = HourglassLevel(next_dim, dims[1:], modules[1:])
        else:
            self.low2 = _residuals([next_dim] * (next_mod + 1))
        self.low3 = _residuals([next_dim] * curr_mod + [curr_dim])

    def forward(self, x):
        low = self.low3(self.low2(self.low1(x)))
        # nearest at exactly 2x picks index i // 2
        return self.up1(x) + F.interpolate(low, scale_factor=2,
                                           mode="nearest")


def _conv_bn(in_channels: int, out_channels: int) -> nn.Sequential:
    """1x1 conv + BN, no ReLU (the reference's inters_ / cnvs_)."""
    return nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, bias=False),
                         BatchNorm2d(out_channels))


class HourglassNet(nn.Module):
    """`num_stacks` hourglasses with per-stack heads (the reference's
    `exkp`).  `forward` returns one dict of NCHW head maps per stack; the
    callers take the last.  `head_conv` is the heads' width (256 in both
    archs)."""

    def __init__(self, heads: Dict[str, int], num_stacks: int = 1,
                 dims: Sequence[int] = DIMS, modules: Sequence[int] = MODULES,
                 head_conv: int = 256):
        super().__init__()
        curr_dim = dims[0]
        self.num_stacks = num_stacks
        self.pre = nn.Sequential(Convolution(7, 3, 128, stride=2),
                                 HourglassResidual(128, PRE_DIM, stride=2))
        self.kps = nn.ModuleList(
            HourglassLevel(PRE_DIM if s == 0 else curr_dim, dims, modules)
            for s in range(num_stacks))
        self.cnvs = nn.ModuleList(Convolution(3, curr_dim, PRE_DIM)
                                  for _ in range(num_stacks))
        self.inters = nn.ModuleList(HourglassResidual(curr_dim, curr_dim)
                                    for _ in range(num_stacks - 1))
        self.inters_ = nn.ModuleList(
            _conv_bn(PRE_DIM if s == 0 else curr_dim, curr_dim)
            for s in range(num_stacks - 1))
        self.cnvs_ = nn.ModuleList(_conv_bn(PRE_DIM, curr_dim)
                                   for _ in range(num_stacks - 1))
        self.heads = dict(heads)
        for name, channels in heads.items():
            stacks = nn.ModuleList(
                nn.Sequential(Convolution(3, PRE_DIM, head_conv,
                                          with_bn=False),
                              nn.Conv2d(head_conv, channels, 1))
                for _ in range(num_stacks))
            for seq in stacks:
                nn.init.constant_(seq[-1].bias, -2.19 if "hm" in name else 0.0)
            self.add_module(name, stacks)

    def forward(self, x) -> List[Dict[str, torch.Tensor]]:
        inter = self.pre(x)
        outs = []
        for s in range(self.num_stacks):
            cnv = self.cnvs[s](self.kps[s](inter))
            outs.append({name: getattr(self, name)[s](cnv)
                         for name in self.heads})
            if s < self.num_stacks - 1:
                inter = self.inters[s](torch.relu(self.inters_[s](inter)
                                                  + self.cnvs_[s](cnv)))
        return outs
