"""Arch-string model factory (reference: src/lib/models/model.py:10-28;
the JAX package's models/factory.py).

Arch strings match the reference CLI surface:
  dla_34 | dlav0_34 | hourglass | smallhourglass | res_18 | res_101 |
  resdcn_18 | resdcn_101
(`res_34`, `res_50` and their resdcn forms build too, as in the JAX
package.)
"""
from __future__ import annotations

from typing import Dict

from torch import nn

from .dla import DLASeg
from .hourglass import HourglassNet
from .resnet import ResNetDet

# arch -> stacks; the heads are 256 wide whatever head_conv says, as in the
# JAX package's factory
HOURGLASS_STACKS = {"hourglass": 2, "smallhourglass": 1}


def _dla(num_layers, heads, head_conv, dcn_kernel, plain=False) -> nn.Module:
    if num_layers != 34:
        raise KeyError(f"only DLA-34 is defined (as in the reference), "
                       f"not DLA-{num_layers}")
    return DLASeg(heads, head_conv=head_conv, dcn_kernel=dcn_kernel,
                  plain_upsample=plain)


def _dlav0(num_layers, heads, head_conv, dcn_kernel) -> nn.Module:
    return _dla(num_layers, heads, head_conv, dcn_kernel, plain=True)


def _hourglass(num_layers, heads, head_conv, dcn_kernel) -> nn.Module:
    return HourglassNet(heads, num_stacks=HOURGLASS_STACKS["hourglass"])


def _smallhourglass(num_layers, heads, head_conv, dcn_kernel) -> nn.Module:
    return HourglassNet(heads, num_stacks=HOURGLASS_STACKS["smallhourglass"])


def _res(num_layers, heads, head_conv, dcn_kernel) -> nn.Module:
    return ResNetDet(heads, num_layers, head_conv)


def _resdcn(num_layers, heads, head_conv, dcn_kernel) -> nn.Module:
    return ResNetDet(heads, num_layers, head_conv, use_dcn=True,
                     dcn_kernel=dcn_kernel)


MODEL_REGISTRY = {
    "dla": _dla,
    "dlav0": _dlav0,
    "hourglass": _hourglass,
    "smallhourglass": _smallhourglass,
    "res": _res,
    "resdcn": _resdcn,
}


def create_model(arch: str, heads: Dict[str, int], head_conv: int,
                 dcn_kernel: str = "auto") -> nn.Module:
    """arch like 'dla_34' or 'smallhourglass' -> module whose forward(x
    NCHW) returns a list of per-stack head dicts (NCHW maps), the
    reference model contract.  An unknown arch raises KeyError, as in the
    JAX package.

    `dcn_kernel` is the DCN mode of every DCNv2 node
    (models.deform_conv.parse_dcn_kernel); dlav0, res_* and the hourglass
    archs have none, so it has no effect there."""
    name, _, depth = arch.partition("_")
    if name not in MODEL_REGISTRY or (depth and not depth.isdigit()):
        raise KeyError(f"unknown arch '{arch}'")
    return MODEL_REGISTRY[name](int(depth or 0), heads, head_conv, dcn_kernel)
