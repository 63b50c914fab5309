"""CenterNet box-detection training loss (reference src/lib/trains/
ctdet.py:20-91 CtdetLoss.forward), as the JAX package's losses/ctdet.py:

  total = hm_weight * focal(sigmoid(hm))      (or the mse of the logits)
        + wh_weight * wh loss                 (l1 | smooth l1 | dense |
                                               norm | cat_spec weighted)
        + off_weight * L1(reg at peaks)

averaged over stacks.  Head maps are NHWC.  With a process group, this
rank's share of the global batch's loss: every denominator is summed over
the group (losses/normalise.py), as polydet_loss does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .focal import clamped_sigmoid, focal_loss
from .normalise import mse_mean
from .regression import (dense_l1_loss, norm_reg_l1_loss, reg_l1_loss,
                         reg_smooth_l1_loss, reg_weighted_l1_loss)


@dataclasses.dataclass(frozen=True)
class CtdetLossConfig:
    """Loss weights and flags; defaults match reference opts.py."""
    hm_weight: float = 1.0
    off_weight: float = 1.0
    wh_weight: float = 0.1
    mse_loss: bool = False
    reg_loss: str = "l1"              # l1 | sl1
    dense_wh: bool = False
    norm_wh: bool = False
    cat_spec_wh: bool = False
    reg_offset: bool = True


def ctdet_loss(outputs: List[Dict[str, torch.Tensor]],
               batch: Dict[str, torch.Tensor], cfg: CtdetLossConfig,
               group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: per-stack dicts of NHWC head maps ('hm' raw logits, 'wh',
    optional 'reg'); batch: 'hm' (B,H,W,C), 'reg_mask' and 'ind' (B,K),
    'wh' (B,K,2) or its dense_wh / cat_spec_wh replacement, optional 'reg'
    (B,K,2).  Returns (loss, stats) with the reference's stat keys."""
    num_stacks = len(outputs)
    hm_l = wh_l = off_l = 0.0
    crit_reg = reg_smooth_l1_loss if cfg.reg_loss == "sl1" else reg_l1_loss
    for out in outputs:
        if cfg.mse_loss:
            hm_l += mse_mean(out["hm"], batch["hm"], group) / num_stacks
        else:
            hm_l += focal_loss(clamped_sigmoid(out["hm"]), batch["hm"],
                               group) / num_stacks
        if cfg.wh_weight > 0:
            if cfg.dense_wh:
                wh = dense_l1_loss(out["wh"], batch["dense_wh_mask"],
                                   batch["dense_wh"], group)
            elif cfg.cat_spec_wh:
                wh = reg_weighted_l1_loss(out["wh"], batch["cat_spec_mask"],
                                          batch["ind"], batch["cat_spec_wh"],
                                          group)
            elif cfg.norm_wh:
                wh = norm_reg_l1_loss(out["wh"], batch["reg_mask"],
                                      batch["ind"], batch["wh"], group)
            else:
                wh = crit_reg(out["wh"], batch["reg_mask"], batch["ind"],
                              batch["wh"], group)
            wh_l += wh / num_stacks
        if cfg.reg_offset and cfg.off_weight > 0:
            off_l += crit_reg(out["reg"], batch["reg_mask"], batch["ind"],
                              batch["reg"], group) / num_stacks
    loss = (cfg.hm_weight * hm_l + cfg.wh_weight * wh_l
            + cfg.off_weight * off_l)
    stats = {"loss": loss, "hm_l": hm_l, "wh_l": wh_l, "off_l": off_l}
    return loss, {k: torch.as_tensor(v) for k, v in stats.items()}
