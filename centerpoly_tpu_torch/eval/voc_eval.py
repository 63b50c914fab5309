"""PASCAL VOC detection AP (the reference's Pascal protocol), in numpy:
the port's copy of the JAX package's eval/voc_eval.py.

The reference scores its pascal dataset through tools/reval.py ->
voc_eval_lib/datasets/voc_eval.py (Fast/er R-CNN evaluator): per-class
greedy max-IoU matching at a single overlap threshold with VOC's
inclusive-pixel box convention (+1 in width/height), "difficult" GT
excluded from both npos and TP/FP, and AP from either the VOC-2007
11-point rule or the area-under-envelope rule
(reference: src/tools/voc_eval_lib/datasets/voc_eval.py:35-215).

This module reproduces that protocol over the COCO-json annotation form
the rest of this codebase uses (CocoPolyAnnotations-like: load_anns /
get_img_ids, bbox = [x, y, w, h]).  A GT entry is treated as difficult
when it carries a truthy "difficult" (or, failing that, "iscrowd") flag.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = True) -> float:
    """AP from a (recall, precision) curve.

    use_07_metric=True: VOC-2007 11-point interpolation (mean of max
    precision at recall >= {0.0, 0.1, ..., 1.0}).  False: exact area
    under the monotone precision envelope (VOC >=2010 / "correct" rule).
    Matches reference voc_eval.py:35-67.
    """
    rec = np.asarray(rec, np.float64)
    prec = np.asarray(prec, np.float64)
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = rec >= t
            p = float(prec[mask].max()) if mask.any() else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _voc_overlaps(bb: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU of one det box vs (G, 4) GT boxes, VOC inclusive-pixel style."""
    ixmin = np.maximum(gt[:, 0], bb[0])
    iymin = np.maximum(gt[:, 1], bb[1])
    ixmax = np.minimum(gt[:, 2], bb[2])
    iymax = np.minimum(gt[:, 3], bb[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    union = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
             + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
             - inter)
    return inter / union


def voc_eval_class(dets_by_img: Dict[int, np.ndarray],
                   gts_by_img: Dict[int, np.ndarray],
                   difficult_by_img: Dict[int, np.ndarray],
                   ovthresh: float = 0.5,
                   use_07_metric: bool = True):
    """(rec, prec, ap) for one class.

    dets_by_img: {img_id: (n, 5) [x1, y1, x2, y2, score]}.
    gts_by_img: {img_id: (g, 4) [x1, y1, x2, y2]} (corner form).
    Protocol per reference voc_eval.py:132-215: detections pooled over
    all images, sorted by confidence; each claims its max-IoU GT; a GT
    already claimed -> FP; a difficult GT absorbs the det (no TP, no FP).
    """
    npos = 0
    claimed = {}
    for img_id, diff in difficult_by_img.items():
        npos += int((~diff.astype(bool)).sum())
        claimed[img_id] = np.zeros(len(diff), bool)

    img_ids: List[int] = []
    scores: List[float] = []
    boxes: List[np.ndarray] = []
    for img_id, det in dets_by_img.items():
        det = np.asarray(det, np.float64).reshape(-1, 5)
        for row in det:
            img_ids.append(img_id)
            scores.append(float(row[4]))
            boxes.append(row[:4])
    nd = len(scores)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    order = np.argsort(-np.asarray(scores), kind="mergesort")
    for rank, d in enumerate(order):
        img_id = img_ids[d]
        gt = gts_by_img.get(img_id)
        gt = (np.zeros((0, 4)) if gt is None
              else np.asarray(gt, np.float64).reshape(-1, 4))
        ovmax, jmax = -np.inf, -1
        if len(gt):
            overlaps = _voc_overlaps(boxes[d], gt)
            jmax = int(np.argmax(overlaps))
            ovmax = float(overlaps[jmax])
        if ovmax > ovthresh:
            if not difficult_by_img[img_id][jmax]:
                if not claimed[img_id][jmax]:
                    tp[rank] = 1.0
                    claimed[img_id][jmax] = True
                else:
                    fp[rank] = 1.0
        else:
            fp[rank] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def evaluate_voc_map(annotations,
                     results: Dict[int, Dict[int, np.ndarray]],
                     ovthresh: float = 0.5,
                     use_07_metric: bool = True,
                     class_names: Optional[Sequence[str]] = None
                     ) -> Dict[str, float]:
    """VOC-protocol mAP over COCO-json-form GT.

    results: {image_id: {category_id: (n, 5) [x1, y1, x2, y2, score]}}.
    Returns {"AP": mAP, "AP_<class or id>": per-class AP, ...} plus the
    protocol tag so readers can't mistake it for COCO numbers.
    """
    img_ids = list(annotations.get_img_ids())
    cat_ids = sorted({a["category_id"]
                      for i in img_ids for a in annotations.load_anns(i)})
    out: Dict[str, float] = {}
    aps = []
    for cat in cat_ids:
        gts_by_img, diff_by_img, dets_by_img = {}, {}, {}
        for img_id in img_ids:
            anns = [a for a in annotations.load_anns(img_id)
                    if a["category_id"] == cat]
            gts_by_img[img_id] = np.array(
                [[a["bbox"][0], a["bbox"][1],
                  a["bbox"][0] + a["bbox"][2],
                  a["bbox"][1] + a["bbox"][3]] for a in anns],
                np.float64).reshape(-1, 4)
            diff_by_img[img_id] = np.array(
                [bool(a.get("difficult", a.get("iscrowd", 0)))
                 for a in anns], bool)
            det = results.get(img_id, {}).get(cat)
            if det is not None and len(det):
                dets_by_img[img_id] = np.asarray(det, np.float64)[:, :5]
        _, _, ap = voc_eval_class(dets_by_img, gts_by_img, diff_by_img,
                                  ovthresh, use_07_metric)
        aps.append(ap)
        name = (class_names[cat] if class_names and cat < len(class_names)
                else str(cat))
        out[f"AP_{name}"] = float(ap)
    out["AP"] = float(np.mean(aps)) if aps else 0.0
    out["protocol"] = ("voc07_11point" if use_07_metric
                       else "voc_auc")  # type: ignore[assignment]
    return out
