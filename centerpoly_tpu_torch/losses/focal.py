"""Penalty-reduced pixel-wise focal loss (CornerNet variant): reference
src/lib/models/losses.py:146-171 (`_neg_loss`) and the sigmoid clamp of
src/lib/models/utils.py:8-10, as the JAX package's losses/focal.py."""
from __future__ import annotations

import torch

from ..geometry.polygon import clip
from .normalise import global_sum


def clamped_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """sigmoid clipped to [eps, 1-eps] (jnp.clip's gradient at a tie)."""
    return clip(torch.sigmoid(x), eps, 1.0 - eps)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor,
               group=None) -> torch.Tensor:
    """Focal loss on an already-sigmoided heatmap: pos (gt == 1)
    -log(p) (1-p)^2, neg -log(1-p) p^2 (1-gt)^4, normalised by the number
    of positives; with none, the unnormalised negative term.  With a
    process group the positives are counted over every rank, and so is
    the choice of branch (losses/normalise.py)."""
    pos_mask = (gt == 1.0).to(pred.dtype)
    neg_mask = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2) * pos_mask
    neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, 2) * neg_weights
                * neg_mask)
    num_pos = global_sum(pos_mask.sum(), group)
    pos_sum, neg_sum = pos_loss.sum(), neg_loss.sum()
    return torch.where(num_pos == 0, -neg_sum,
                       -(pos_sum + neg_sum) / torch.clamp_min(num_pos, 1.0))
