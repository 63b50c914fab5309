"""COCO-protocol bbox mAP evaluator in numpy: the port's copy of the JAX
package's eval/coco_eval.py.

The reference evaluates coco/pascal/uadetrac ctdet results through
pycocotools' COCOeval (reference: src/lib/datasets/dataset/coco.py:104-112,
src/tools/eval_coco.py). This module does not use that
library; it implements the matching protocol directly:

  * IoU thresholds 0.50:0.05:0.95 (10),
  * 101-point recall interpolation,
  * score-sorted greedy matching, ignoring crowd GT,
  * area ranges all / small / medium / large, maxDets 100,
  * AP / AP50 / AP75 / APs / APm / APl + AR@100.

Detections: {image_id: {category_id: (n, 5) [x0, y0, x1, y1, score]}}.
GT: a CocoPolyAnnotations-like object (load_anns / get_img_ids).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def bbox_iou_matrix(dets: np.ndarray, gts: np.ndarray,
                    iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; crowd GT uses intersection-over-det-area like COCO."""
    d = dets[:, None, :]
    g = gts[None, :, :]
    ix = np.maximum(
        0.0, np.minimum(d[..., 2], g[..., 2])
        - np.maximum(d[..., 0], g[..., 0]))
    iy = np.maximum(
        0.0, np.minimum(d[..., 3], g[..., 3])
        - np.maximum(d[..., 1], g[..., 1]))
    inter = ix * iy
    da = ((dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1]))[:, None]
    ga = ((gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]))[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


def _match_image(dets: np.ndarray, gts: np.ndarray, gt_ignore: np.ndarray,
                 iscrowd: np.ndarray, n_thrs: int):
    """COCOeval.evaluateImg equivalent for one (image, category).

    Returns (dt_matches[T, D], dt_ignore[T, D], dt_scores[D], n_gt)."""
    order = np.argsort(-dets[:, 4], kind="mergesort")
    dets = dets[order]
    gt_order = np.argsort(gt_ignore, kind="mergesort")
    gts = gts[gt_order]
    gt_ig = gt_ignore[gt_order]
    crowd = iscrowd[gt_order]

    D, G = len(dets), len(gts)
    dtm = np.zeros((n_thrs, D), np.int64)
    dt_ig = np.zeros((n_thrs, D), bool)
    if G:
        ious = bbox_iou_matrix(dets[:, :4], gts, crowd)
    for t, thr in enumerate(IOU_THRS[:n_thrs]):
        gtm = np.zeros(G, np.int64)
        for di in range(D):
            iou = float(thr)
            best = -1
            for gi in range(G):
                if gtm[gi] and not crowd[gi]:
                    continue
                # matched-to-visible beats any ignored match
                if best > -1 and not gt_ig[best] and gt_ig[gi]:
                    break
                if ious[di, gi] < iou:
                    continue
                iou = ious[di, gi]
                best = gi
            if best == -1:
                continue
            dtm[t, di] = 1
            dt_ig[t, di] = bool(gt_ig[best])
            gtm[best] = 1
    n_gt = int((~gt_ignore.astype(bool)).sum())
    return dtm, dt_ig, dets[:, 4], n_gt


def evaluate_coco_map(annotations, results: Dict[int, Dict[int, np.ndarray]],
                      max_dets: int = 100,
                      area_range: str = "all") -> Dict[str, float]:
    """Compute COCO bbox metrics over `results` vs `annotations` GT."""
    lo, hi = AREA_RANGES[area_range]
    cat_ids = sorted({a["category_id"]
                      for i in annotations.get_img_ids()
                      for a in annotations.load_anns(i)})
    T = len(IOU_THRS)
    ap_acc: List[np.ndarray] = []
    ar_acc: List[float] = []

    for cat in cat_ids:
        dtm_all, dtig_all, scores_all = [], [], []
        n_gt_total = 0
        for img_id in annotations.get_img_ids():
            anns = [a for a in annotations.load_anns(img_id)
                    if a["category_id"] == cat]
            gts = np.array([[a["bbox"][0], a["bbox"][1],
                             a["bbox"][0] + a["bbox"][2],
                             a["bbox"][1] + a["bbox"][3]]
                            for a in anns], np.float32).reshape(-1, 4)
            areas = np.array([a.get("area",
                                    a["bbox"][2] * a["bbox"][3])
                              for a in anns], np.float32)
            crowd = np.array([bool(a.get("iscrowd", 0)) for a in anns],
                             dtype=bool)
            gt_ignore = crowd | (areas < lo) | (areas > hi)

            det = results.get(img_id, {}).get(cat, np.zeros((0, 5)))
            det = np.asarray(det, np.float32).reshape(-1, 5)
            if len(det) > max_dets:
                det = det[np.argsort(-det[:, 4], kind="mergesort")
                          ][:max_dets]
            dtm, dt_ig, scores, n_gt = _match_image(
                det, gts, gt_ignore.astype(np.float32), crowd, T)
            # unmatched detections outside the area range are ignored
            d_area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
            if len(det):
                d_sorted = np.argsort(-det[:, 4], kind="mergesort")
                out_rng = ((d_area < lo) | (d_area > hi))[d_sorted]
                dt_ig = dt_ig | (dtm == 0) & out_rng[None, :]
            dtm_all.append(dtm)
            dtig_all.append(dt_ig)
            scores_all.append(scores)
            n_gt_total += n_gt

        if n_gt_total == 0:
            continue
        dtm = np.concatenate(dtm_all, axis=1)
        dtig = np.concatenate(dtig_all, axis=1)
        scores = np.concatenate(scores_all)
        order = np.argsort(-scores, kind="mergesort")
        dtm = dtm[:, order]
        dtig = dtig[:, order]

        tps = (dtm == 1) & ~dtig
        fps = (dtm == 0) & ~dtig
        tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
        prec_t = np.zeros((T, len(RECALL_THRS)))
        rec_last = np.zeros(T)
        for t in range(T):
            tp, fp = tp_cum[t], fp_cum[t]
            rc = tp / n_gt_total
            pr = tp / np.maximum(tp + fp, 1e-12)
            rec_last[t] = rc[-1] if len(rc) else 0.0
            # monotone non-increasing precision envelope
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, RECALL_THRS, side="left")
            q = np.zeros(len(RECALL_THRS))
            valid = inds < len(pr)
            q[valid] = pr[inds[valid]]
            prec_t[t] = q
        ap_acc.append(prec_t)
        ar_acc.append(rec_last.mean())

    if not ap_acc:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "AR100": 0.0}
    prec = np.stack(ap_acc)  # (C, T, R)
    return {
        "AP": float(prec.mean()),
        "AP50": float(prec[:, 0].mean()),
        "AP75": float(prec[:, 5].mean()),
        "AR100": float(np.mean(ar_acc)),
    }


def evaluate_coco_map_areas(annotations,
                            results: Dict[int, Dict[int, np.ndarray]],
                            max_dets: int = 100) -> Dict[str, float]:
    """Full COCO summary: AP/AP50/AP75/AR100 plus APs/APm/APl.

    Mirrors COCOeval.summarize()'s 12-metric table subset that the
    reference prints via pycocotools (src/lib/datasets/dataset/coco.py).
    """
    out = evaluate_coco_map(annotations, results, max_dets, "all")
    for rng, key in (("small", "APs"), ("medium", "APm"), ("large", "APl")):
        out[key] = evaluate_coco_map(annotations, results, max_dets, rng)["AP"]
    return out
