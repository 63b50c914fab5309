"""Human-pose training loss (the multi_pose task), as the JAX package's
losses/multi_pose.py (reference src/lib/trains/multi_pose.py:19-87,
MultiPoseLoss.forward): the centre focal term, the joints' offsets from
the centre (weighted by each joint's visibility, or dense under the
gaussian with dense_hp), wh and centre offset regression, the joint heat
maps' focal (or MSE) term and the joints' sub-pixel offsets, averaged
over stacks.

Head maps are NHWC.  With a process group every denominator is summed
over the group (losses/normalise.py), as ctdet_loss does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .focal import clamped_sigmoid, focal_loss
from .normalise import mse_mean
from .regression import (dense_l1_loss, reg_l1_loss, reg_smooth_l1_loss,
                         reg_weighted_l1_loss)


@dataclasses.dataclass(frozen=True)
class MultiPoseLossConfig:
    hm_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0
    hp_weight: float = 1.0
    hm_hp_weight: float = 1.0
    mse_loss: bool = False
    reg_loss: str = "l1"              # l1 | sl1
    dense_hp: bool = False
    hm_hp: bool = True
    reg_hp_offset: bool = True
    reg_offset: bool = True


def multi_pose_loss(outputs: List[Dict[str, torch.Tensor]],
                    batch: Dict[str, torch.Tensor], cfg: MultiPoseLossConfig,
                    group=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: per-stack dicts of NHWC head maps (`hm` and `hm_hp` raw
    logits, `wh`, `hps`, `reg`, `hp_offset`); batch: the multi_pose
    sampler's targets.  Returns (loss, stats) with the reference's stat
    keys."""
    num_stacks = len(outputs)
    hm_l = wh_l = off_l = hp_l = hm_hp_l = hp_off_l = 0.0
    crit_reg = reg_smooth_l1_loss if cfg.reg_loss == "sl1" else reg_l1_loss
    for out in outputs:
        if cfg.mse_loss:
            hm_l += mse_mean(out["hm"], batch["hm"], group) / num_stacks
        else:
            hm_l += focal_loss(clamped_sigmoid(out["hm"]), batch["hm"],
                               group) / num_stacks
        if cfg.dense_hp:
            hp_l += dense_l1_loss(out["hps"], batch["dense_hps_mask"],
                                  batch["dense_hps"], group) / num_stacks
        else:
            hp_l += reg_weighted_l1_loss(out["hps"], batch["hps_mask"],
                                         batch["ind"], batch["hps"],
                                         group) / num_stacks
        if cfg.wh_weight > 0:
            wh_l += crit_reg(out["wh"], batch["reg_mask"], batch["ind"],
                             batch["wh"], group) / num_stacks
        if cfg.reg_offset and cfg.off_weight > 0:
            off_l += crit_reg(out["reg"], batch["reg_mask"], batch["ind"],
                              batch["reg"], group) / num_stacks
        if cfg.reg_hp_offset and cfg.off_weight > 0:
            hp_off_l += crit_reg(out["hp_offset"], batch["hp_mask"],
                                 batch["hp_ind"], batch["hp_offset"],
                                 group) / num_stacks
        if cfg.hm_hp and cfg.hm_hp_weight > 0:
            if cfg.mse_loss:
                hm_hp_l += mse_mean(out["hm_hp"], batch["hm_hp"],
                                    group) / num_stacks
            else:
                hm_hp_l += focal_loss(clamped_sigmoid(out["hm_hp"]),
                                      batch["hm_hp"], group) / num_stacks
    loss = (cfg.hm_weight * hm_l + cfg.wh_weight * wh_l
            + cfg.off_weight * off_l + cfg.hp_weight * hp_l
            + cfg.hm_hp_weight * hm_hp_l + cfg.off_weight * hp_off_l)
    stats = {"loss": loss, "hm_l": hm_l, "hp_l": hp_l, "hm_hp_l": hm_hp_l,
             "hp_off_l": hp_off_l, "wh_l": wh_l, "off_l": off_l}
    return loss, {k: torch.as_tensor(v) for k, v in stats.items()}
