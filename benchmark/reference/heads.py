"""Prediction heads.

Each head is conv3x3(head_conv) -> ReLU -> conv1x1(channels), as the
reference's `nn.Sequential` (children 0 / 1 / 2, pose_dla_dcn.py:446-468);
heatmap heads get bias -2.19 so the initial sigmoid is ~0.1.
"""
from __future__ import annotations

from typing import Mapping

from torch import nn


def head_stack(heads: Mapping[str, int], in_channels: int,
               head_conv: int = 256) -> nn.ModuleDict:
    """One Sequential per head, keyed by head name; the model registers
    each under its own name so the state_dict keys are the reference's
    (`hm.0.weight`, `hm.2.bias`, ...)."""
    out = nn.ModuleDict()
    for name, channels in heads.items():
        seq = nn.Sequential(
            nn.Conv2d(in_channels, head_conv, 3, padding=1, bias=True),
            nn.ReLU(inplace=True),
            nn.Conv2d(head_conv, channels, 1, bias=True))
        nn.init.constant_(seq[-1].bias, -2.19 if "hm" in name else 0.0)
        out[name] = seq
    return out
