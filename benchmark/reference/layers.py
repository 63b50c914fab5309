"""Shared building blocks (NCHW) of the reference networks, named as
CenterPoly's torch modules (pose_dla_dcn.py).

Conv + BatchNorm + ReLU blocks and the DLA basic residual block
(reference pose_dla_dcn.py:26-63), so a reference state_dict loads with
no renaming.  Convolutions keep the symmetric torch padding
`pad = dilation * (k // 2)`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose running variance tracks the *biased* batch variance
    (CenterPoly's flax rebuild; nn.BatchNorm2d tracks the unbiased one).
    Training normalises with the biased batch statistics; momentum 0.1."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(_at_least_f32(x), dim=(0, 2, 3),
                                       correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def _at_least_f32(x):
    """x in the dtype BatchNorm takes its statistics in: f32, or f64 for a
    net in f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class ConvBN(nn.Sequential):
    """Conv -> BatchNorm -> optional ReLU, children named 0 / 1 / 2 like
    the reference's `nn.Sequential(conv, bn, relu)` blocks."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, relu: bool = True):
        pad = dilation * (kernel // 2)
        layers = [nn.Conv2d(in_channels, out_channels, kernel, stride, pad,
                            dilation, bias=False),
                  BatchNorm2d(out_channels)]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


class Residual(nn.Module):
    """Basic 3x3-3x3 residual block (reference BasicBlock): conv1/bn1,
    conv2/bn2; the caller may pass the residual branch."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride,
                               dilation, dilation, bias=False)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, 1, dilation,
                               dilation, bias=False)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + residual)


def bilinear_upsample_kernel(size: int) -> np.ndarray:
    """1-channel bilinear kernel used to init grouped transposed convs
    (ref pose_dla_dcn.py:335-344)."""
    f = int(np.ceil(size / 2))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((size, size), dtype=np.float32)
    for i in range(size):
        for j in range(size):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    return w
