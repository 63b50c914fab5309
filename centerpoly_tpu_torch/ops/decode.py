"""On-device detection decode: heatmap -> top-K detections.

Reference decode path: src/lib/models/decode.py (_nms :13-19, _topk
:117-133, polydet_decode :512-670, ctdet_decode :479-510), vectorized as
in the JAX package.  Maps are NHWC at these functions, the JAX package's
layout.  Polydet rows are [x0, y0, x1, y1, score, class, poly_0..
poly_{2N-1}, depth], ctdet rows [x0, y0, x1, y1, score, class].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .gather import gather_feat_nhwc


def pseudo_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima: 3x3 max-pool equality mask (ref decode.py:13-19)."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, stride=1,
                        padding=pad).permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, 0.0)


def topk_heatmap(scores: torch.Tensor, k: int):
    """Two-stage top-K over an NHWC heatmap (ref decode.py:117-133):
    per-class top-K over positions, then global top-K over the C*K
    candidates.  Returns (scores, flat_inds, classes, ys, xs), each (B, K)."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    cls_scores, cls_inds = torch.topk(flat, k)              # (B, C, K)
    cls_ys = torch.div(cls_inds, w, rounding_mode="floor").float()
    cls_xs = (cls_inds % w).float()

    topk_score, topk_ind = torch.topk(cls_scores.reshape(b, c * k), k)
    topk_cls = torch.div(topk_ind, k, rounding_mode="floor").float()

    def pick(x):
        return torch.gather(x.reshape(b, c * k), 1, topk_ind)

    return topk_score, pick(cls_inds), topk_cls, pick(cls_ys), pick(cls_xs)


def polydet_decode(heat: torch.Tensor, polys: torch.Tensor,
                   depth: torch.Tensor, reg: torch.Tensor | None = None,
                   k: int = 128, rep: str = "cartesian") -> torch.Tensor:
    """Decode polydet head maps (NHWC: heat (B,H,W,C) after sigmoid, polys
    (B,H,W,2N), depth (B,H,W,1), reg (B,H,W,2) or None) into
    (B, K, 6 + 2N + 1) detections; rep is cartesian | polar | polar_fixed."""
    b = heat.shape[0]
    n2 = polys.shape[-1]

    heat = pseudo_nms(heat)
    scores, inds, clses, ys, xs = topk_heatmap(heat, k)

    if reg is not None:
        reg_k = gather_feat_nhwc(reg, inds)                 # (B, K, 2)
        xs = xs[..., None] + reg_k[:, :, 0:1]
        ys = ys[..., None] + reg_k[:, :, 1:2]
    else:
        xs = xs[..., None] + 0.5
        ys = ys[..., None] + 0.5

    poly_k = gather_feat_nhwc(polys, inds)                  # (B, K, 2N)
    depth_k = gather_feat_nhwc(depth, inds)                 # (B, K, 1)

    if rep in ("polar", "polar_fixed"):
        r = poly_k[..., 0::2]
        theta = poly_k[..., 1::2]
        if rep == "polar_fixed":
            # the reference's literal 2*3.14 (decode.py:605), kept for
            # output parity
            j = torch.arange(0, n2, 2, dtype=torch.float32, device=r.device)
            theta = (2 * 3.14 - (2 * 3.14 / n2) * j).expand_as(r)
        px = r * torch.cos(theta)
        py = r * torch.sin(theta)
    else:
        px = poly_k[..., 0::2]
        py = poly_k[..., 1::2]

    px = px + xs
    py = py + ys
    bboxes = torch.cat([px.amin(2, keepdim=True), py.amin(2, keepdim=True),
                        px.amax(2, keepdim=True), py.amax(2, keepdim=True)], 2)
    poly_out = torch.stack([px, py], -1).reshape(b, k, n2)
    return torch.cat([bboxes, scores[..., None], clses[..., None], poly_out,
                      depth_k], 2)


def ctdet_decode(heat: torch.Tensor, wh: torch.Tensor,
                 reg: torch.Tensor | None = None, k: int = 100,
                 cat_spec_wh: bool = False) -> torch.Tensor:
    """CenterNet box decode (ref decode.py:479-510) of NHWC maps: heat
    (B,H,W,C) after sigmoid, wh (B,H,W,2) or, under cat_spec_wh,
    (B,H,W,2C) with each class's own pair taken at its peaks; reg
    (B,H,W,2) or None.  Returns (B, K, 6) rows [x0, y0, x1, y1, score,
    class]."""
    heat = pseudo_nms(heat)
    scores, inds, clses, ys, xs = topk_heatmap(heat, k)

    if reg is not None:
        reg_k = gather_feat_nhwc(reg, inds)
        xs = xs[..., None] + reg_k[:, :, 0:1]
        ys = ys[..., None] + reg_k[:, :, 1:2]
    else:
        xs = xs[..., None] + 0.5
        ys = ys[..., None] + 0.5

    wh_k = gather_feat_nhwc(wh, inds)                       # (B, K, 2[C])
    if cat_spec_wh:
        b, kk = scores.shape
        idx = clses.long()[..., None, None].expand(b, kk, 1, 2)
        wh_k = torch.gather(wh_k.reshape(b, kk, -1, 2), 2, idx)[:, :, 0]

    bboxes = torch.cat([xs - wh_k[..., 0:1] / 2, ys - wh_k[..., 1:2] / 2,
                        xs + wh_k[..., 0:1] / 2, ys + wh_k[..., 1:2] / 2], 2)
    return torch.cat([bboxes, scores[..., None], clses[..., None]], 2)
