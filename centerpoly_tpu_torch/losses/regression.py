"""Masked regression losses at gathered peak indices: reference
losses.py:817-830 (RegL1Loss), :201-216 (RegLoss, smooth L1),
:1093-1118 (NormRegL1Loss, RegWeightedL1Loss) and trains/ctdet.py:69-74
(the dense wh branch), as the JAX package's losses/regression.py.

Every denominator is summed over the ranks of `group` when one is given
(losses/normalise.py), so a data-parallel step normalises over the global
batch.  |x| is `abs_`, jnp.abs's gradient at 0."""
from __future__ import annotations

import torch

from ..geometry.polygon import abs_
from ..ops.gather import gather_feat_nhwc
from .normalise import global_sum


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor, group=None) -> torch.Tensor:
    """L1 at peaks. output (B,H,W,D); mask (B,K); ind (B,K); target
    (B,K,D); normalised by the expanded mask sum (objects x D)."""
    pred = gather_feat_nhwc(output, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    return abs_(pred * m - target * m).sum() / (global_sum(m.sum(), group)
                                                + 1e-4)


def reg_smooth_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                       ind: torch.Tensor, target: torch.Tensor,
                       group=None) -> torch.Tensor:
    """Smooth L1 (beta 1) at peaks, normalised by the unexpanded mask sum
    (the number of objects), as the reference does."""
    pred = gather_feat_nhwc(output, ind)
    num = mask.to(pred.dtype).sum()
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    diff = abs_(pred * m - target * m)
    loss = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return loss.sum() / (global_sum(num, group) + 1e-4)


def norm_reg_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                     ind: torch.Tensor, target: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Target-normalised L1: the prediction over (target + 1e-4),
    regressed toward 1."""
    pred = gather_feat_nhwc(output, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    pred = pred / (target + 1e-4)
    loss = abs_(pred * m - torch.ones_like(target) * m).sum()
    return loss / (global_sum(m.sum(), group) + 1e-4)


def reg_weighted_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                         ind: torch.Tensor, target: torch.Tensor,
                         group=None) -> torch.Tensor:
    """L1 at peaks under a per-element (B, K, D) mask (cat_spec_wh)."""
    pred = gather_feat_nhwc(output, ind)
    m = mask.to(pred.dtype)
    return abs_(pred * m - target * m).sum() / (global_sum(m.sum(), group)
                                                + 1e-4)


def dense_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                  target: torch.Tensor, group=None) -> torch.Tensor:
    """Masked L1 over whole (B, H, W, D) maps, normalised by the mask sum
    (dense_wh)."""
    m = mask.to(output.dtype)
    return abs_(output * m - target * m).sum() / (global_sum(m.sum(), group)
                                                  + 1e-4)
