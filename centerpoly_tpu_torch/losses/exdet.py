"""ExtremeNet training loss (the exdet task), as the JAX package's
losses/exdet.py (reference src/lib/trains/exdet.py:17-42,
ExdetLoss.forward): a focal (or MSE) term on each of the five heat maps
(top, left, bottom, right extreme points and the centre) plus masked L1
on the four extreme points' sub-pixel offsets, averaged over stacks.

Head maps are NHWC.  With a process group, this rank's share of the
global batch's loss: every denominator is summed over the group
(losses/normalise.py), as ctdet_loss does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .focal import clamped_sigmoid, focal_loss
from .normalise import mse_mean
from .regression import reg_l1_loss

PARTS = ("t", "l", "b", "r", "c")


@dataclasses.dataclass(frozen=True)
class ExdetLossConfig:
    hm_weight: float = 1.0
    off_weight: float = 1.0
    mse_loss: bool = False
    reg_offset: bool = True


def exdet_loss(outputs: List[Dict[str, torch.Tensor]],
               batch: Dict[str, torch.Tensor], cfg: ExdetLossConfig,
               group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: per-stack dicts of NHWC head maps (`hm_{t,l,b,r,c}` raw
    logits, `reg_{t,l,b,r}`); batch: the five `hm_*` targets and, with
    reg_offset, `reg_mask` (B,K), `ind_{t,l,b,r}` (B,K) and
    `reg_{t,l,b,r}` (B,K,2).  Returns (loss, stats) with the reference's
    stat keys."""
    num_stacks = len(outputs)
    hm_l = off_l = 0.0
    for out in outputs:
        for p in PARTS:
            tag = f"hm_{p}"
            if cfg.mse_loss:
                hm_l += mse_mean(out[tag], batch[tag], group) / num_stacks
            else:
                hm_l += focal_loss(clamped_sigmoid(out[tag]), batch[tag],
                                   group) / num_stacks
            if p != "c" and cfg.reg_offset and cfg.off_weight > 0:
                off_l += reg_l1_loss(out[f"reg_{p}"], batch["reg_mask"],
                                     batch[f"ind_{p}"], batch[f"reg_{p}"],
                                     group) / num_stacks
    loss = cfg.hm_weight * hm_l + cfg.off_weight * off_l
    stats = {"loss": loss, "hm_l": hm_l, "off_l": off_l}
    return loss, {k: torch.as_tensor(v) for k, v in stats.items()}
