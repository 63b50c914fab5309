"""The polydet v2 training loss (CenterPoly src/lib/trains/polydet.py:
38-162 and losses.py:146-171, 817-959) on one device:

  total = hm_weight * focal(sigmoid(hm)) + off_weight * L1(reg at peaks)
        + poly_weight * (poly L1 + polygon IoU + vertex order)
        + depth_weight * L1(depth at peaks)

Head maps are NHWC (B, H, W, C) f32; the batch holds the targets of
traffic/targets.py."""
from __future__ import annotations

from typing import Dict, List

import torch

from .polygon import abs_, clip, polar_to_cartesian, polygon_iou


def gather_nhwc(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) at flat indices y * W + x (B, K) -> (B, K, C)."""
    b, h, w, c = feat.shape
    return torch.gather(feat.reshape(b, h * w, c), 1,
                        ind.long()[:, :, None].expand(-1, -1, c))


def focal_loss(pred, gt):
    """Penalty-reduced focal loss on a sigmoided heat map, over the
    number of positives (the negative term alone where there is none)."""
    pos_mask = (gt == 1.0).to(pred.dtype)
    neg_mask = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2) * pos_mask
    neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, 2) * neg_weights
                * neg_mask)
    num_pos = pos_mask.sum()
    pos_sum, neg_sum = pos_loss.sum(), neg_loss.sum()
    return torch.where(num_pos == 0, -neg_sum,
                       -(pos_sum + neg_sum) / torch.clamp_min(num_pos, 1.0))


def reg_l1_loss(output, mask, ind, target):
    """L1 at peaks over the expanded mask sum (objects x D) + 1e-4."""
    pred = gather_nhwc(output, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    return abs_(pred * m - target * m).sum() / (m.sum() + 1e-4)


def _unwrap_angles(angles):
    """Once a positive angle has been seen (in vertex order), negative
    angles get +2*3.14 (CenterPoly's literal, losses.py:894-899)."""
    seen_pos = torch.cumsum((angles > 0).int(), dim=-1) > 0
    return torch.where((angles < 0) & seen_pos, angles + 2 * 3.14, angles)


def order_loss(pred_poly, mask):
    """Sum over masked objects of max(0, theta_j - theta_k), j < k, over
    (10 * mask.sum() + 1e-4)."""
    angles = _unwrap_angles(pred_poly[..., 1::2])
    n = angles.shape[-1]
    diff = angles[..., :, None] - angles[..., None, :]
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool,
                                  device=angles.device), diagonal=1)
    pos = torch.maximum(diff, torch.zeros_like(diff)) * upper
    per_obj = pos.sum(dim=(-1, -2))
    m = mask.to(per_obj.dtype)
    return (per_obj * m).sum() / (10.0 * m.sum() + 1e-4)


def poly_iou_loss(pred_poly, target_poly, mask):
    """1 - sum(IoU) / (mask.sum() + 1e-6): predicted (r, theta) pairs
    sorted by theta (stable), |r|, exact IoU against the target."""
    b, k, n2 = pred_poly.shape
    n = n2 // 2
    pred = pred_poly.reshape(b, k, n, 2)
    tgt = target_poly.reshape(b, k, n, 2)
    order = torch.argsort(pred[..., 1], dim=-1, stable=True)
    pred = torch.gather(pred, 2, order[..., None].expand(b, k, n, 2))
    pred = torch.cat([abs_(pred[..., 0:1]), pred[..., 1:2]], dim=-1)
    iou = polygon_iou(polar_to_cartesian(pred), polar_to_cartesian(tgt))
    m = mask.to(iou.dtype)
    return 1.0 - (iou * m).sum() / (m.sum() + 1e-6)


def poly_l1_polar(pred, target, mask):
    """Polar L1: |r| error on the even channels + sum(1 - cos(dtheta)) on
    the odd ones, over the expanded mask sum + 1e-6."""
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    radii = torch.zeros(pred.shape[-1], dtype=pred.dtype, device=pred.device)
    radii[0::2] = 1.0
    am = 1.0 - radii
    loss = abs_(pred * m * radii - target * m * radii).sum()
    loss = loss + (1.0 - torch.cos(pred * m * am - target * m * am)).sum()
    return loss / (m.sum() + 1e-6)


def polydet_loss(outputs: List[Dict[str, torch.Tensor]], batch,
                 weights: Dict[str, float]):
    """The v2 loss (rep polar, poly_loss l1+iou, poly_order) averaged over
    stacks -> (loss, {term: value})."""
    n = len(outputs)
    hm_l = off_l = poly_l = depth_l = order_l = 0.0
    for out in outputs:
        hm_l += focal_loss(clip(torch.sigmoid(out["hm"]), 1e-4, 1 - 1e-4),
                           batch["hm"]) / n
        depth_l += reg_l1_loss(out["pseudo_depth"], batch["reg_mask"],
                               batch["ind"], batch["pseudo_depth"]) / n
        pred = gather_nhwc(out["poly"], batch["ind"])
        poly_l += (poly_iou_loss(pred, batch["poly"], batch["reg_mask"])
                   + poly_l1_polar(pred, batch["poly"],
                                   batch["reg_mask"])) / n
        order_l += order_loss(pred, batch["reg_mask"]) / n
        off_l += reg_l1_loss(out["reg"], batch["reg_mask"], batch["ind"],
                             batch["reg"]) / n
    loss = (weights["hm"] * hm_l + weights["off"] * off_l
            + weights["poly"] * (poly_l + order_l)
            + weights["depth"] * depth_l)
    return loss, {"hm_l": hm_l, "off_l": off_l, "poly_l": poly_l,
                  "order_l": order_l, "depth_l": depth_l}
