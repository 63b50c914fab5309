"""The polydet task's part of the benchmark: the training targets of a
frame's objects, the reference's loss, and the comparison of served
polygons with the plain reference.

Targets: the val-mode (no augmentation) polydet encoding of the port's
data/sampler.py: the frame centred and scaled by its longer side onto
the input, the class heat map an elliptical gaussian at the polygon's
centroid, the polar (r, theta) offsets of its vertices, the sub-pixel
offset, the flat peak index and the mask (0 for a polar object whose
leading angles are inverted).

Serving: a frame's served rows ({class id: rows [x0, y0, x1, y1, score,
polygon 2N, depth]}, K rows over all classes) against the reference's
decode of every output pixel (reference/detect.py).  Each served row is
matched to the output pixel whose decoded box and polygon lie nearest
to its own, and read there:

  poly       the largest gap (frame pixels) between the row's box and
             polygon and that pixel's;
  score      the gap in logits between the row's score and the
             reference's score of the row's own class at that pixel, so
             a wrong class, head, sigmoid or match reads here whatever
             the ties between peaks;
  depth      the gap between the row's depth and the reference's there;
  kth_score  the gap in logits between the frame's lowest served score
             and the reference's K-th best peak over all classes (a peak
             is a pixel equal to its 3x3 max), so the top-K has to cut
             where the reference's does;
  rows       how far the number of rows is from K.

Each of the first four numbers is the widest over the checked frames,
compared as that of the program over the same of the reference itself
run in bf16 on the same frames (`numbers`): the random networks amplify
rounding by a factor that changes from seed to seed by more than bf16
and fp8 differ, so the gaps are read in units of the reference's own
bf16 rounding on this seed's weights and frames.  The absolute gaps
come beside them, read but not compared.  `row_count_gap` is compared
exactly.  A frame that does not come back, or a row of a class that the
configuration does not have, fails."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import detect, loss

MAX_OBJS = 128
GAPS = ("score", "kth_score", "poly", "depth")
# the least gap of the reference in bf16 that a program's gap is read
# against (a reference that rounds to nothing would make any gap infinite)
FLOOR = 1e-6


# -- training --------------------------------------------------------------

def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet radius so any center within it keeps IoU >= min_overlap."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 16 * c2)) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def _gaussian_ellipse2d(shape, sigma: float) -> np.ndarray:
    h, w = shape
    max_radius = max(h, w)
    rows = (np.arange(h) - h // 2) * (w / max_radius)
    cols = (np.arange(w) - w // 2) * (h / max_radius)
    return np.exp(-(rows[:, None] ** 2 + cols[None, :] ** 2)
                  / (2 * sigma ** 2))


def splat_ellipse_gaussian(heatmap, center, radius_x: int, radius_y: int):
    """Max-merge an elliptical gaussian at `center` (x, y)."""
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius_x), min(width - x, radius_x + 1)
    top, bottom = min(y, radius_y), min(height - y, radius_y + 1)
    sigma = (2 * min(radius_x, radius_y) + 1) / 6
    g = _gaussian_ellipse2d((2 * radius_y + 1, 2 * radius_x + 1), sigma)
    hm = heatmap[y - top:y + bottom, x - left:x + right]
    gg = g[radius_y - top:radius_y + bottom, radius_x - left:radius_x + right]
    if min(gg.shape) > 0 and min(hm.shape) > 0:
        np.maximum(hm, gg, out=hm)


def targets(objects, frame_hw, out_hw, conf: dict) -> dict:
    """The polydet targets of one frame's objects at an output of
    `out_hw`: {hm (H, W, C), reg_mask (M,), ind (M,) int32, poly (M, 2N)
    polar, pseudo_depth (M, 1), reg (M, 2)}, M = 128, C and N the
    configuration's classes and vertices."""
    n_points = conf["nbr_points"]
    frame_h, frame_w = frame_hw
    out_h, out_w = out_hw
    scale = out_w / float(max(frame_h, frame_w))
    shift = np.array([out_w / 2.0 - frame_w / 2.0 * scale,
                      out_h / 2.0 - frame_h / 2.0 * scale])
    hm = np.zeros((out_h, out_w, conf["num_classes"]), np.float32)
    poly = np.zeros((MAX_OBJS, n_points * 2), np.float32)
    depth = np.zeros((MAX_OBJS, 1), np.float32)
    reg = np.zeros((MAX_OBJS, 2), np.float32)
    ind = np.zeros((MAX_OBJS,), np.int32)
    mask = np.zeros((MAX_OBJS,), np.float32)
    for k, (pts, cls, pd, (bx, by, bw, bh)) in enumerate(objects[:MAX_OBJS]):
        v = pts.astype(np.float64) * scale + shift
        v[:, 0] = np.clip(v[:, 0], 0, out_w - 1)
        v[:, 1] = np.clip(v[:, 1], 0, out_h - 1)
        box = np.array([bx, by, bx + bw, by + bh], np.float32)
        box = (box.reshape(2, 2) * scale + shift).astype(np.float32)
        box[:, 0] = np.clip(box[:, 0], 0, out_w - 1)
        box[:, 1] = np.clip(box[:, 1], 0, out_h - 1)
        h, w = box[1, 1] - box[0, 1], box[1, 0] - box[0, 0]
        if h <= 0 or w <= 0:
            continue
        radius = max(0, int(gaussian_radius((math.ceil(h), math.ceil(w)))))
        ct = v.mean(axis=0).astype(np.float32)
        ct_int = ct.astype(np.int32)
        radius_x = radius if h > w else int(radius * (w / h))
        radius_y = radius if w >= h else int(radius * (h / w))
        splat_ellipse_gaussian(hm[:, :, cls], ct_int, radius_x, radius_y)
        d = v - ct[None, :]
        x, y = d[:, 0], d[:, 1]
        theta = np.arctan((y + 1e-8) / (x + 1e-8))
        theta = np.where(x < 0, theta + np.pi,
                         np.where(y < 0, theta + 2 * np.pi, theta))
        poly[k, 0::2] = np.sqrt(x * x + y * y)
        poly[k, 1::2] = theta
        depth[k] = pd
        ind[k] = ct_int[1] * out_w + ct_int[0]
        reg[k] = ct - ct_int
        mask[k] = 0.0 if poly[k, 1] > poly[k, 5] else 1.0
    return {"hm": hm, "reg_mask": mask, "ind": ind, "poly": poly,
            "pseudo_depth": depth, "reg": reg}


def reference_loss(outputs, batch, conf: dict):
    """(loss, {term: value}) of the plain reference's v2 loss."""
    return loss.polydet_loss(outputs, batch, conf["train"]["loss_weights"])


# -- serving ---------------------------------------------------------------

def served_results(heads, to_frame: np.ndarray, conf: dict):
    """The reference's heads served as the port's detector serves them:
    [{"results": {class id: rows}}], the K best peaks of each frame."""
    return detect.served_results(heads, to_frame, conf["K"])


def decode(heads, to_frame: np.ndarray) -> dict:
    """The reference's reading of every output pixel of a batch:
    {"scores" (B, C, P), "coords" (B, P, 4 + 2N), "depth" (B, P),
    "peaks" (B, C, P)}."""
    scores, coords, depth = detect.pixel_detections(heads, to_frame)
    return {"scores": scores, "coords": coords, "depth": depth,
            "peaks": detect.peak_scores(heads)}


def served_rows(results: dict, width: int):
    """(classes (n,) from 0, rows (n, width)) of one frame's results."""
    cls, rows = [np.zeros(0, np.int64)], [np.zeros((0, width), np.float32)]
    for c, r in results.items():
        r = np.asarray(r, np.float32).reshape(-1, width)
        cls.append(np.full(len(r), int(c) - 1))
        rows.append(r)
    return np.concatenate(cls), np.concatenate(rows)


def logit(p):
    """The logit of a score, from its sigmoid."""
    p = np.clip(np.asarray(p, np.float64), 1e-12, 1 - 1e-12)
    return np.log(p) - np.log1p(-p)


def frame_gaps(results, ref: dict, j: int, conf: dict):
    """One served frame's gaps against frame `j` of the reference's
    `decode` (module docstring): {"rows": int, "score", "kth_score",
    "poly", "depth": arrays}; None for a frame that did not come back."""
    if results is None:
        return None
    k, n_cls = conf["K"], conf["num_classes"]
    cls, rows = served_rows(results, 5 + 2 * conf["nbr_points"] + 1)
    out = {"rows": abs(len(rows) - k)}
    want = torch.topk(ref["peaks"][j].flatten(), k).values[-1].item()
    if not len(rows):
        return out | {"kth_score": np.array([math.inf]),
                      **{g: np.zeros(0) for g in ("score", "poly",
                                                  "depth")}}
    out["kth_score"] = np.abs(logit(rows[:, 4].min()) - logit([want]))
    coords = ref["coords"][j]
    dev = coords.device
    got = torch.from_numpy(np.concatenate([rows[:, :4], rows[:, 5:-1]],
                                          1)).to(dev)
    best, where = [], []
    for s in range(0, len(got), 16):
        d = (got[s:s + 16, None, :] - coords[None]).abs().amax(-1)
        v, i = d.min(1)
        best.append(v)
        where.append(i)
    best, where = torch.cat(best), torch.cat(where)
    out["poly"] = best.double().cpu().numpy()
    out["depth"] = (torch.from_numpy(rows[:, -1]).to(dev)
                    - ref["depth"][j][where]).abs().double().cpu().numpy()
    known = (cls >= 0) & (cls < n_cls)
    c = torch.from_numpy(np.where(known, cls, 0)).to(dev)
    s_ref = ref["scores"][j][c, where].cpu().numpy()
    out["score"] = np.where(known, np.abs(logit(rows[:, 4]) - logit(s_ref)),
                            math.inf)
    return out


def numbers(got, own, conf: dict) -> dict:
    """{number: value} of the program's frames' gaps `got` over the bf16
    reference's `own` (module docstring), with the absolute gaps of both
    beside them (`<number>.abs`, `<number>.bf16`)."""
    missing = any(g is None for g in got)
    got = [g for g in got if g is not None]

    def widest(frames, key):
        return max([float(np.max(g[key], initial=0.0)) for g in frames]
                   + [0.0])
    out = {}
    for key in GAPS:
        w, w16 = widest(got, key), widest(own, key)
        out[f"{key}_gap"] = math.inf if missing else w / max(w16, FLOOR)
        out[f"{key}_gap.abs"] = w
        out[f"{key}_gap.bf16"] = w16
    out["row_count_gap"] = (conf["K"] if missing
                            else max([g["rows"] for g in got] + [0]))
    return out
