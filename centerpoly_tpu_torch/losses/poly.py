"""Polygon losses: L1 (cartesian / polar / polar_fixed / deadzone), exact
polygon-IoU and the vertex-order loss (reference losses.py:833-959
PolyLoss.forward), as the JAX package's losses/poly.py: the IoU is the
fixed-shape closed form of geometry/polygon.py over every object slot at
once, masked."""
from __future__ import annotations

import torch

from ..geometry.polygon import abs_, polar_to_cartesian, polygon_iou
from ..ops.gather import gather_feat_nhwc
from .normalise import global_sum, share


def _unwrap_angles(angles: torch.Tensor) -> torch.Tensor:
    """Once a positive angle has been seen (in vertex order), negative
    angles get +2*3.14 (the reference's literal, losses.py:894-899)."""
    seen_pos = torch.cumsum((angles > 0).int(), dim=-1) > 0
    return torch.where((angles < 0) & seen_pos, angles + 2 * 3.14, angles)


def order_loss(pred_poly: torch.Tensor, mask: torch.Tensor,
               group=None) -> torch.Tensor:
    """Sum over masked objects of max(0, theta_j - theta_k) for j < k,
    over (10 * mask.sum() + 1e-4) (ref losses.py:891-906).
    pred_poly (B, K, 2N) polar; mask (B, K).  `group`: the mask summed
    over its ranks (losses/normalise.py), as in each loss below."""
    angles = _unwrap_angles(pred_poly[..., 1::2])
    n = angles.shape[-1]
    diff = angles[..., :, None] - angles[..., None, :]
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool,
                                  device=angles.device), diagonal=1)
    pos = torch.maximum(diff, torch.zeros_like(diff)) * upper
    per_obj = pos.sum(dim=(-1, -2))
    m = mask.to(per_obj.dtype)
    return (per_obj * m).sum() / (10.0 * global_sum(m.sum(), group) + 1e-4)


def poly_iou_loss(pred_poly: torch.Tensor, target_poly: torch.Tensor,
                  mask: torch.Tensor, group=None) -> torch.Tensor:
    """1 - sum(IoU) / (mask.sum() + 1e-6) over masked objects: predicted
    (r, theta) pairs sorted by theta (stable, as jnp.argsort), |r|, exact
    IoU against the target polygon (ref losses.py:876-888)."""
    b, k, n2 = pred_poly.shape
    n = n2 // 2
    pred = pred_poly.reshape(b, k, n, 2)
    tgt = target_poly.reshape(b, k, n, 2)
    order = torch.argsort(pred[..., 1], dim=-1, stable=True)
    pred = torch.gather(pred, 2, order[..., None].expand(b, k, n, 2))
    pred = torch.cat([abs_(pred[..., 0:1]), pred[..., 1:2]], dim=-1)
    iou = polygon_iou(polar_to_cartesian(pred), polar_to_cartesian(tgt))
    m = mask.to(iou.dtype)
    return share(group) - (iou * m).sum() / (global_sum(m.sum(), group)
                                             + 1e-6)


def poly_l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                 rep: str, deadzone: float | None = None,
                 group=None) -> torch.Tensor:
    """Masked L1 over polygon channels (ref losses.py:910-945), normalised
    by the expanded mask sum (objects x 2N) + 1e-6.  cartesian: plain L1
    (with `deadzone`, only |err| >= it counts); polar: L1 on the radii
    (even channels) + sum(1 - cos(dtheta)); polar_fixed: radii only."""
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    norm = global_sum(m.sum(), group) + 1e-6
    if rep == "cartesian":
        err = abs_(pred * m - target * m)
        if deadzone is not None:
            err = err * (err >= deadzone)
        return err.sum() / norm
    radii = torch.zeros(pred.shape[-1], dtype=pred.dtype, device=pred.device)
    radii[0::2] = 1.0
    loss = abs_(pred * m * radii - target * m * radii).sum()
    if rep == "polar":
        am = 1.0 - radii
        loss = loss + (1.0 - torch.cos(pred * m * am - target * m * am)).sum()
    elif rep != "polar_fixed":
        raise NotImplementedError(f"rep={rep}")
    return loss / norm


def poly_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
              target: torch.Tensor, rep: str = "cartesian", kind: str = "l1",
              with_order: bool = False, group=None):
    """Polygon loss dispatch (ref losses.py:838-959).  output (B, H, W, 2N)
    head map; mask, ind (B, K); target (B, K, 2N) in `rep`; kind l1 | iou |
    l1+iou | relu.  Returns the loss, or (loss, order) with `with_order`.
    The IoU term needs a polar rep (the JAX package's fix of the
    reference, which read cartesian (x, y) as (r, theta))."""
    pred = gather_feat_nhwc(output, ind)
    loss = 0.0
    if kind in ("iou", "l1+iou", "relu"):
        if rep == "cartesian":
            if kind != "relu":
                raise ValueError(
                    "poly_loss kind 'iou'/'l1+iou' requires a polar "
                    "rep: poly_iou_loss sorts (r, theta) pairs by theta")
        else:
            loss = poly_iou_loss(pred, target, mask, group)
    if kind in ("l1", "l1+iou"):
        loss = loss + poly_l1_loss(pred, target, mask, rep, group=group)
    elif kind == "relu":
        loss = loss + poly_l1_loss(pred, target, mask, rep, deadzone=20.0,
                                   group=group)
    if with_order:
        return loss, order_loss(pred, mask, group)
    return loss
