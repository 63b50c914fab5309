"""On-device detection decode: heatmap -> top-K detections.

Reference decode path: src/lib/models/decode.py (_nms :13-19, the
directional aggregation :21-73, _topk_channel :100-110, _topk :117-133,
exct_decode :287-446, ddd_decode :448-477, ctdet_decode :479-510,
polydet_decode :512-670, multi_pose_decode :672-746), vectorized as in
the JAX package.  Maps are
NHWC at these functions, the JAX package's layout.  Polydet rows are
[x0, y0, x1, y1, score, class, poly_0..poly_{2N-1}, depth], ctdet rows
[x0, y0, x1, y1, score, class], multi_pose rows [x0, y0, x1, y1, score,
34 joint coords, class], exdet rows [x0, y0, x1, y1, score, t_x, t_y, l_x,
l_y, b_x, b_y, r_x, r_y, class], ddd rows [x, y, score, rot 8, depth, dim
3, (wh 2), class].
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


def topk_channel(scores: torch.Tensor, k: int):
    """Per-channel top-K over positions (ref decode.py:100-110) of an NHWC
    map: (scores, flat_inds, ys, xs), each (B, C, K)."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    topk_scores, topk_inds = torch.topk(flat, k)
    ys = torch.div(topk_inds, w, rounding_mode="floor").float()
    xs = (topk_inds % w).float()
    return topk_scores, topk_inds, ys, xs


def multi_pose_decode(heat: torch.Tensor, wh: torch.Tensor,
                      kps: torch.Tensor, reg: torch.Tensor | None = None,
                      hm_hp: torch.Tensor | None = None,
                      hp_offset: torch.Tensor | None = None,
                      k: int = 100) -> torch.Tensor:
    """Human-pose decode (ref decode.py:672-746) of NHWC maps: heat
    (B,H,W,C) and hm_hp (B,H,W,J) after sigmoid, wh (B,H,W,2), kps
    (B,H,W,2J) joint offsets from the centre, reg and hp_offset (B,H,W,2)
    or None.  Returns (B, K, 5 + 2J + 1) rows.  With hm_hp each regressed
    joint snaps to the nearest confident joint peak (score > 0.1) that
    lies in its box and within 0.3 of the box's longer side, all
    (B, J, K detections, K peaks) distances at once; argmin takes the
    first of equal distances."""
    b = heat.shape[0]
    num_joints = kps.shape[-1] // 2

    heat = pseudo_nms(heat)
    scores, inds, clses, ys, xs = topk_heatmap(heat, k)

    kps_k = gather_feat_nhwc(kps, inds)                     # (B, K, 2J)
    kps_x = kps_k[..., 0::2] + xs[..., None]
    kps_y = kps_k[..., 1::2] + ys[..., None]

    if reg is not None:
        reg_k = gather_feat_nhwc(reg, inds)
        xs = xs[..., None] + reg_k[:, :, 0:1]
        ys = ys[..., None] + reg_k[:, :, 1:2]
    else:
        xs = xs[..., None] + 0.5
        ys = ys[..., None] + 0.5
    wh_k = gather_feat_nhwc(wh, inds)
    bboxes = torch.cat([xs - wh_k[..., 0:1] / 2, ys - wh_k[..., 1:2] / 2,
                        xs + wh_k[..., 0:1] / 2, ys + wh_k[..., 1:2] / 2], 2)

    if hm_hp is not None:
        thresh = 0.1
        hm_hp = pseudo_nms(hm_hp)
        hm_score, hm_inds, hm_ys, hm_xs = topk_channel(hm_hp, k)  # (B,J,K)
        if hp_offset is not None:
            off = gather_feat_nhwc(hp_offset, hm_inds.reshape(b, -1))
            off = off.reshape(b, num_joints, k, 2)
            hm_xs = hm_xs + off[..., 0]
            hm_ys = hm_ys + off[..., 1]
        else:
            hm_xs = hm_xs + 0.5
            hm_ys = hm_ys + 0.5
        conf = hm_score > thresh
        hm_score = torch.where(conf, hm_score, -1.0)
        hm_ys = torch.where(conf, hm_ys, -10000.0)
        hm_xs = torch.where(conf, hm_xs, -10000.0)

        # (B, J, K detections, K peaks)
        reg_x = kps_x.transpose(1, 2)[..., None]
        reg_y = kps_y.transpose(1, 2)[..., None]
        dist = torch.sqrt((reg_x - hm_xs[:, :, None, :]) ** 2
                          + (reg_y - hm_ys[:, :, None, :]) ** 2)
        min_ind = torch.argmin(dist, dim=3)                 # (B, J, K)
        min_dist = torch.gather(dist, 3, min_ind[..., None])[..., 0]
        sel_score = torch.gather(hm_score, 2, min_ind)
        sel_x = torch.gather(hm_xs, 2, min_ind)
        sel_y = torch.gather(hm_ys, 2, min_ind)

        left, top = bboxes[:, None, :, 0], bboxes[:, None, :, 1]
        right, btm = bboxes[:, None, :, 2], bboxes[:, None, :, 3]
        bad = ((sel_x < left) | (sel_x > right) | (sel_y < top)
               | (sel_y > btm) | (sel_score < thresh)
               | (min_dist > torch.maximum(btm - top, right - left) * 0.3))
        kps_x = torch.where(bad, kps_x.transpose(1, 2), sel_x).transpose(1, 2)
        kps_y = torch.where(bad, kps_y.transpose(1, 2), sel_y).transpose(1, 2)

    kps_out = torch.stack([kps_x, kps_y], -1).reshape(b, k, num_joints * 2)
    return torch.cat([bboxes, scores[..., None], kps_out, clses[..., None]],
                     2)


def _agg_scan(heat: torch.Tensor, axis: int, reverse: bool) -> torch.Tensor:
    """Directional monotone aggregation (ref decode.py:21-73) along `axis`:
    ret[i] = heat[i] + ret[i-1] * (heat[i] >= heat[i-1]), from the far end
    with `reverse`; returns the accumulated extra, ret - heat, as the
    reference's helpers do.  A loop over the rows (the detector never
    sets aggr_weight)."""
    x = heat.movedim(axis, 0)
    prev_ret = torch.zeros_like(x[0])
    prev_heat = torch.full_like(x[0], float("inf"))
    out = [None] * x.shape[0]
    order = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for i in order:
        row = x[i]
        prev_ret = row + prev_ret * (row >= prev_heat)
        prev_heat = row
        out[i] = prev_ret
    return torch.stack(out).movedim(0, axis) - heat


def exct_decode(t_heat: torch.Tensor, l_heat: torch.Tensor,
                b_heat: torch.Tensor, r_heat: torch.Tensor,
                ct_heat: torch.Tensor, t_regr=None, l_regr=None, b_regr=None,
                r_regr=None, k: int = 40, scores_thresh: float = 0.1,
                center_thresh: float = 0.1, aggr_weight: float = 0.0,
                num_dets: int = 1000) -> torch.Tensor:
    """ExtremeNet decode (ref decode.py:287-446) of NHWC maps after
    sigmoid: every (top, left, bottom, right) combination of the four
    maps' top-K peaks, a (B, K, K, K, K) lattice built by broadcasting,
    scored by the four peaks and twice the centre map at the implied
    centre ((l_x + r_x + 0.5) / 2 truncated, likewise y; the top peak's
    class), minus 1 for each broken rule (a score under its threshold,
    classes that differ, and each of the four ordering rules); the
    `num_dets` best.  Returns (B, num_dets, 14) rows."""
    batch, height, width, _ = t_heat.shape

    if aggr_weight > 0:
        t_heat = t_heat + aggr_weight * (
            _agg_scan(t_heat, 2, False) + _agg_scan(t_heat, 2, True))
        b_heat = b_heat + aggr_weight * (
            _agg_scan(b_heat, 2, False) + _agg_scan(b_heat, 2, True))
        l_heat = l_heat + aggr_weight * (
            _agg_scan(l_heat, 1, False) + _agg_scan(l_heat, 1, True))
        r_heat = r_heat + aggr_weight * (
            _agg_scan(r_heat, 1, False) + _agg_scan(r_heat, 1, True))

    # each edge map's peaks: (score, class, y, x, y and x + offset), (B, K)
    peaks = []
    for heat, regr in ((t_heat, t_regr), (l_heat, l_regr),
                       (b_heat, b_regr), (r_heat, r_regr)):
        sc, inds, cls, ys, xs = topk_heatmap(
            torch.clamp_max(pseudo_nms(heat), 1.0), k)
        if t_regr is not None:
            off = gather_feat_nhwc(regr, inds)
            peaks.append((sc, cls, ys, xs, ys + off[..., 1], xs + off[..., 0]))
        else:
            peaks.append((sc, cls, ys, xs, ys + 0.5, xs + 0.5))

    def ax(v, i):
        """(B, K) -> the lattice's axis i (0 t, 1 l, 2 b, 3 r)."""
        shape = [batch, 1, 1, 1, 1]
        shape[i + 1] = k
        return v.reshape(shape)

    ((t_sc, t_cls, t_ys, t_xs), (l_sc, l_cls, l_ys, l_xs),
     (b_sc, b_cls, b_ys, b_xs), (r_sc, r_cls, r_ys, r_xs)) = [
        [ax(v, i) for v in p[:4]] for i, p in enumerate(peaks)]

    # the centre map at the implied box centre, in the top peak's class
    box_cx = ((l_xs + r_xs + 0.5) / 2).to(torch.int64)
    box_cy = ((t_ys + b_ys + 0.5) / 2).to(torch.int64)
    ct_flat = ct_heat.permute(0, 3, 1, 2).reshape(batch, -1)
    ct_inds = (t_cls.to(torch.int64) * (height * width) + box_cy * width
               + box_cx).reshape(batch, -1)
    ct_scores = torch.gather(ct_flat, 1, ct_inds).reshape(batch, k, k, k, k)

    scores = (t_sc + l_sc + b_sc + r_sc + 2 * ct_scores) / 6
    cls_bad = (t_cls != l_cls) | (t_cls != b_cls) | (t_cls != r_cls)
    top_bad = (t_ys > l_ys) | (t_ys > b_ys) | (t_ys > r_ys)
    left_bad = (l_xs > t_xs) | (l_xs > b_xs) | (l_xs > r_xs)
    bottom_bad = (b_ys < t_ys) | (b_ys < l_ys) | (b_ys < r_ys)
    right_bad = (r_xs < t_xs) | (r_xs < l_xs) | (r_xs < b_xs)
    sc_bad = ((t_sc < scores_thresh) | (l_sc < scores_thresh)
              | (b_sc < scores_thresh) | (r_sc < scores_thresh)
              | (ct_scores < center_thresh))
    for bad in (sc_bad, cls_bad, top_bad, left_bad, bottom_bad, right_bad):
        scores = scores - bad.to(scores.dtype)

    top_scores, top_inds = torch.topk(scores.reshape(batch, -1), num_dets)
    # a lattice index is ((t * K + l) * K + b) * K + r
    which = [torch.div(top_inds, k ** (3 - i), rounding_mode="floor") % k
             for i in range(4)]

    def pick(i, col):
        """Column `col` of edge i's peaks at the best cells."""
        return torch.gather(peaks[i][col], 1, which[i])

    cls, y, x = 1, 4, 5
    t, left, b, r = range(4)
    cols = [pick(left, x), pick(t, y), pick(r, x), pick(b, y), top_scores,
            pick(t, x), pick(t, y), pick(left, x), pick(left, y),
            pick(b, x), pick(b, y), pick(r, x), pick(r, y), pick(t, cls)]
    return torch.stack(cols, 2)


def ddd_decode(heat: torch.Tensor, rot: torch.Tensor, depth: torch.Tensor,
               dim: torch.Tensor, wh: torch.Tensor | None = None,
               reg: torch.Tensor | None = None, k: int = 40) -> torch.Tensor:
    """3D box decode (ref decode.py:448-477) of NHWC maps: heat (B,H,W,C)
    after sigmoid, rot (B,H,W,8), depth (B,H,W,1) already transformed,
    dim (B,H,W,3), wh (B,H,W,2) or None, reg (B,H,W,2) or None.  Returns
    (B, K, 16) rows [x, y, score, rot 8, depth, dim 3, class], 18 with
    wh's two columns before the class."""
    heat = pseudo_nms(heat)
    scores, inds, clses, ys, xs = topk_heatmap(heat, k)
    if reg is not None:
        reg_k = gather_feat_nhwc(reg, inds)
        xs = xs[..., None] + reg_k[:, :, 0:1]
        ys = ys[..., None] + reg_k[:, :, 1:2]
    else:
        xs = xs[..., None] + 0.5
        ys = ys[..., None] + 0.5
    cols = [xs, ys, scores[..., None], gather_feat_nhwc(rot, inds),
            gather_feat_nhwc(depth, inds), gather_feat_nhwc(dim, inds)]
    if wh is not None:
        cols.append(gather_feat_nhwc(wh, inds))
    cols.append(clses[..., None])
    return torch.cat(cols, 2)
