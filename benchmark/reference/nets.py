"""The reference network of a configuration, by its `arch`:
reference/archs/<arch>.py, whose `build(conf, max_offset_y)` reads the
configuration's own keys (heads, head_conv, and what else the network
takes).  A later network is a new file there."""
from __future__ import annotations

import importlib

from torch import nn


def clamp_of(dcn_kernel: str) -> int | None:
    """The y-clamp of the DCN sampling offsets that a DCN mode states:
    R for `rowband:R`, none for the exact mode."""
    mode, _, r = dcn_kernel.partition(":")
    return int(r) if mode == "rowband" else None


def build(conf: dict, dcn_kernel: str = "off") -> nn.Module:
    """The reference network of `conf`, its DCN nodes (if any) with the
    clamp of `dcn_kernel`; forward(x NCHW) -> [head maps]."""
    try:
        arch = importlib.import_module(f".archs.{conf['arch']}",
                                       __package__)
    except ModuleNotFoundError as e:
        raise KeyError(f"no reference network for arch "
                       f"{conf['arch']!r}") from e
    return arch.build(conf, clamp_of(dcn_kernel))
