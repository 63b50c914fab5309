"""Masked L1 at gathered peak indices: reference losses.py:817-830
(RegL1Loss), as the JAX package's losses/regression.py::reg_l1_loss."""
from __future__ import annotations

import torch

from ..geometry.polygon import abs_
from ..ops.gather import gather_feat_nhwc
from .normalise import global_sum


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor, group=None) -> torch.Tensor:
    """L1 at peaks. output (B,H,W,D); mask (B,K); ind (B,K); target
    (B,K,D); normalised by the expanded mask sum (objects x D), over every
    rank of `group` when one is given (losses/normalise.py)."""
    pred = gather_feat_nhwc(output, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    return abs_(pred * m - target * m).sum() / (global_sum(m.sum(), group)
                                                + 1e-4)
