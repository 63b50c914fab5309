"""Arch-string model factory (reference: src/lib/models/model.py:10-28)."""
from __future__ import annotations

from typing import Dict

from torch import nn

from .dla import DLASeg


def create_model(arch: str, heads: Dict[str, int], head_conv: int,
                 dcn_kernel: str = "auto") -> nn.Module:
    """arch -> module whose forward(x NCHW) returns a list of per-stack
    head dicts (NCHW maps), the reference model contract.

    `dcn_kernel` is the DCN mode of every DCNv2 node
    (models.deform_conv.parse_dcn_kernel)."""
    if arch == "dla_34":
        return DLASeg(heads, head_conv=head_conv, dcn_kernel=dcn_kernel)
    raise NotImplementedError(
        f"arch {arch!r} is not ported yet: smallhourglass/hourglass are "
        f"ROADMAP.md queue A item 5, the others item 9")
