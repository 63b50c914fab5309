"""Arch-string model factory (reference: src/lib/models/model.py:10-28)."""
from __future__ import annotations

from typing import Dict

from torch import nn

from .dla import DLASeg
from .hourglass import HourglassNet

# arch -> stacks; the heads are 256 wide whatever head_conv says, as in the
# JAX package's factory
HOURGLASS_STACKS = {"hourglass": 2, "smallhourglass": 1}


def create_model(arch: str, heads: Dict[str, int], head_conv: int,
                 dcn_kernel: str = "auto") -> nn.Module:
    """arch -> module whose forward(x NCHW) returns a list of per-stack
    head dicts (NCHW maps), the reference model contract.

    `dcn_kernel` is the DCN mode of every DCNv2 node
    (models.deform_conv.parse_dcn_kernel); the hourglass archs have none,
    so it has no effect there."""
    if arch == "dla_34":
        return DLASeg(heads, head_conv=head_conv, dcn_kernel=dcn_kernel)
    if arch in HOURGLASS_STACKS:
        return HourglassNet(heads, num_stacks=HOURGLASS_STACKS[arch])
    raise NotImplementedError(
        f"arch {arch!r} is not ported yet: res_*, resdcn_* and dlav0_34 wait "
        f"in ROADMAP.md queue A (secondary surface)")
