"""3D box-estimation training loss (the ddd task), as the JAX package's
losses/ddd.py (reference src/lib/trains/ddd.py:17-64, DddLoss.forward):

    hm_weight * focal(sigmoid(hm)) (or MSE)
    + dep_weight * L1(1 / sigmoid(dep) - 1 at the peaks)
    + dim_weight * L1(dim) + rot_weight * BinRot(rot)
    + wh_weight * L1(wh) [reg_bbox] + off_weight * L1(reg) [reg_offset],

averaged over stacks; depth and dimensions masked by reg_mask (0 under
aug_ddd), rotation, wh and offset by rot_mask.  Head maps are NHWC.
With a process group, this rank's share of the global batch's loss:
every denominator is summed over the group (losses/normalise.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .focal import clamped_sigmoid, focal_loss
from .normalise import mse_mean
from .regression import bin_rot_loss, reg_l1_loss


@dataclasses.dataclass(frozen=True)
class DddLossConfig:
    """Weights and flags; defaults match the reference's opts.py."""
    hm_weight: float = 1.0
    dep_weight: float = 1.0
    dim_weight: float = 1.0
    rot_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0
    mse_loss: bool = False
    reg_bbox: bool = True
    reg_offset: bool = True


def ddd_depth_transform(dep_logits: torch.Tensor) -> torch.Tensor:
    """The inverse-sigmoid depth, 1 / (sigmoid + 1e-6) - 1 (ref
    trains/ddd.py:33), in f32 at least (an f64 map stays f64): a bf16
    head map is widened first, as the detector widens its heads."""
    x = dep_logits.to(torch.promote_types(dep_logits.dtype, torch.float32))
    return 1.0 / (torch.sigmoid(x) + 1e-6) - 1.0


def ddd_loss(outputs: List[Dict[str, torch.Tensor]],
             batch: Dict[str, torch.Tensor], cfg: DddLossConfig,
             group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: per-stack dicts of NHWC head maps (`hm` raw logits, `dep`,
    `rot`, `dim`, `wh`, `reg`); batch: the sampler's `hm`, `ind`,
    `reg_mask`, `rot_mask`, `dep`, `dim`, `rotbin`, `rotres`, `wh` and,
    with reg_offset, `reg`.  Returns (loss, stats) with the reference's
    stat keys."""
    num_stacks = len(outputs)
    hm_l = dep_l = rot_l = dim_l = wh_l = off_l = 0.0
    for out in outputs:
        if cfg.mse_loss:
            hm_l += mse_mean(out["hm"], batch["hm"], group) / num_stacks
        else:
            hm_l += focal_loss(clamped_sigmoid(out["hm"]), batch["hm"],
                               group) / num_stacks
        if cfg.dep_weight > 0:
            dep_l += reg_l1_loss(ddd_depth_transform(out["dep"]),
                                 batch["reg_mask"], batch["ind"],
                                 batch["dep"], group) / num_stacks
        if cfg.dim_weight > 0:
            dim_l += reg_l1_loss(out["dim"], batch["reg_mask"], batch["ind"],
                                 batch["dim"], group) / num_stacks
        if cfg.rot_weight > 0:
            rot_l += bin_rot_loss(out["rot"], batch["rot_mask"],
                                  batch["ind"], batch["rotbin"],
                                  batch["rotres"], group) / num_stacks
        if cfg.reg_bbox and cfg.wh_weight > 0:
            wh_l += reg_l1_loss(out["wh"], batch["rot_mask"], batch["ind"],
                                batch["wh"], group) / num_stacks
        if cfg.reg_offset and cfg.off_weight > 0:
            off_l += reg_l1_loss(out["reg"], batch["rot_mask"], batch["ind"],
                                 batch["reg"], group) / num_stacks
    loss = (cfg.hm_weight * hm_l + cfg.dep_weight * dep_l
            + cfg.dim_weight * dim_l + cfg.rot_weight * rot_l
            + cfg.wh_weight * wh_l + cfg.off_weight * off_l)
    stats = {"loss": loss, "hm_l": hm_l, "dep_l": dep_l, "dim_l": dim_l,
             "rot_l": rot_l, "wh_l": wh_l, "off_l": off_l}
    return loss, {k: torch.as_tensor(v) for k, v in stats.items()}
