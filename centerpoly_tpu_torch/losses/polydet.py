"""Combined polydet training loss (reference src/lib/trains/polydet.py:
38-162 PolydetLoss.forward), as the JAX package's losses/polydet.py:

  total = hm_weight * focal(sigmoid(hm)) + off_weight * L1(reg at peaks)
        + poly_weight * (poly [+ order]) + depth_weight * L1(depth at peaks)

averaged over stacks.  Head maps are NHWC here, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .focal import clamped_sigmoid, focal_loss
from .normalise import global_sum
from .poly import poly_loss
from .regression import reg_l1_loss


@dataclasses.dataclass(frozen=True)
class PolydetLossConfig:
    """Loss weights and flags; defaults match reference opts.py."""
    hm_weight: float = 1.0
    off_weight: float = 1.0
    poly_weight: float = 1.0
    depth_weight: float = 0.1
    rep: str = "cartesian"            # cartesian | polar | polar_fixed
    poly_loss: str = "l1"             # l1 | iou | l1+iou | relu
    poly_order: bool = False
    reg_offset: bool = True
    mse_loss: bool = False


def _check_poly_target(pred: torch.Tensor, batch) -> None:
    """The polygon term reads `poly` (B, K, 2N) against a head of 2N
    channels.  Under --dense_poly the sampler drops `poly` for
    `dense_poly`, and under --cat_spec_poly the head has num_classes x 2N
    channels; no polydet loss reads those targets (the JAX package's loss
    fails at this point on both), so training stops here."""
    if "poly" not in batch:
        raise ValueError(
            "--dense_poly: the batch carries dense_poly in place of poly, "
            "and no polydet loss reads dense_poly")
    if pred.shape[-1] != batch["poly"].shape[-1]:
        raise ValueError(
            f"--cat_spec_poly: the poly head has {pred.shape[-1]} channels "
            f"(one polygon a class) against a {batch['poly'].shape[-1]}-"
            f"channel poly target, and no polydet loss reads cat_spec_poly")


def polydet_loss(outputs: List[Dict[str, torch.Tensor]],
                 batch: Dict[str, torch.Tensor], cfg: PolydetLossConfig,
                 group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: per-stack dicts of NHWC head maps (raw logits for 'hm');
    batch: 'hm' (B,H,W,C), 'reg_mask' (B,K), 'ind' (B,K), 'poly'
    (B,K,2N), 'pseudo_depth' (B,K,1), optional 'reg' (B,K,2).  Returns
    (loss, stats) with the reference's stat keys.  With a process group,
    this rank's share of the global batch's loss and stats: every
    denominator is summed over the group (losses/normalise.py), so the
    ranks' shares sum to the global values."""
    num_stacks = len(outputs)
    hm_l = off_l = poly_l = depth_l = order_l = 0.0
    for out in outputs:
        if cfg.mse_loss:
            sq = (out["hm"] - batch["hm"]) ** 2
            hm_l += (torch.mean(sq) if group is None else sq.sum() / global_sum(
                sq.new_tensor(sq.numel()), group)) / num_stacks
        else:
            hm_l += focal_loss(clamped_sigmoid(out["hm"]),
                               batch["hm"], group) / num_stacks
        depth_l += reg_l1_loss(out["pseudo_depth"], batch["reg_mask"],
                               batch["ind"], batch["pseudo_depth"],
                               group) / num_stacks
        _check_poly_target(out["poly"], batch)
        p = poly_loss(out["poly"], batch["reg_mask"], batch["ind"],
                      batch["poly"], rep=cfg.rep, kind=cfg.poly_loss,
                      with_order=cfg.poly_order, group=group)
        if cfg.poly_order:
            poly_l += p[0] / num_stacks
            order_l += p[1] / num_stacks
        else:
            poly_l += p / num_stacks
        if cfg.reg_offset and cfg.off_weight > 0:
            off_l += reg_l1_loss(out["reg"], batch["reg_mask"], batch["ind"],
                                 batch["reg"], group) / num_stacks
    poly_total = poly_l + order_l if cfg.poly_order else poly_l
    loss = (cfg.hm_weight * hm_l + cfg.off_weight * off_l
            + cfg.poly_weight * poly_total + cfg.depth_weight * depth_l)
    stats = {"loss": loss, "hm_l": hm_l, "off_l": off_l, "poly_l": poly_l,
             "depth_l": depth_l}
    if cfg.poly_order:
        stats["order_l"] = order_l
    return loss, {k: torch.as_tensor(v) for k, v in stats.items()}
