"""Instance-segmentation AP evaluator, official Cityscapes protocol (the
JAX package's eval/instance_eval.py, a plain copy of its numpy; reference
src/lib/datasets/evaluation/cityscapesscripts/evaluation/
evalInstanceLevelSemanticLabeling.py: matching :301-397, AP :398-594):
IoU thresholds 0.50:0.05:0.95, minRegionSize 100 px, group/void ignore
handling, per-gt greedy confidence matching, and the step-wise
precision-recall integration.  Every float64 operation runs in the JAX
package's order, so the APs are equal to the last digit.  Intersections
are one bincount per prediction.

GT convention (Cityscapes *_instanceIds.png): pixel value = labelID * 1000
+ index for real instances, bare labelID for group regions; labels with
ignoreInEval are void.  Mask PNGs are read with utils/png.py.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.png import read_mask


# Cityscapes label ids (public benchmark definition)
CITYSCAPES_INSTANCE_LABELS = {
    24: "person", 25: "rider", 26: "car", 27: "truck", 28: "bus",
    31: "train", 32: "motorcycle", 33: "bicycle",
}
# hasInstances but excluded from eval (caravan, trailer) are void-like
CITYSCAPES_VOID_IDS = tuple(
    list(range(0, 7)) + [9, 10, 14, 15, 16, 18, 29, 30, -1])


@dataclasses.dataclass
class InstanceEvalConfig:
    overlaps: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05))
    min_region_size: int = 100
    instance_labels: Dict[int, str] = dataclasses.field(
        default_factory=lambda: dict(CITYSCAPES_INSTANCE_LABELS))
    void_ids: Sequence[int] = CITYSCAPES_VOID_IDS


def gt_instances_from_image(gt: np.ndarray, cfg: InstanceEvalConfig):
    """Extract gt instance records {label: [ {instID, pixelCount,
    is_group} ]} from an instance-id image."""
    out = {name: [] for name in cfg.instance_labels.values()}
    ids, counts = np.unique(gt, return_counts=True)
    for inst_id, count in zip(ids.tolist(), counts.tolist()):
        label_id = inst_id // 1000 if inst_id >= 1000 else inst_id
        name = cfg.instance_labels.get(label_id)
        if name is None:
            continue
        out[name].append({
            "instID": int(inst_id),
            "pixelCount": int(count),
            "is_group": inst_id < 1000,
        })
    return out


def match_image(gt: np.ndarray, preds: List[dict], cfg: InstanceEvalConfig):
    """Associate predictions with gt instances for one image.

    preds: [{'mask': bool (H, W) or None, 'labelID': int, 'conf': float}].
    Returns (gtInstances, predInstances) in the benchmark's structure.
    """
    gt_instances = gt_instances_from_image(gt, cfg)
    for insts in gt_instances.values():
        for g in insts:
            g["matchedPred"] = []

    pred_instances = {name: [] for name in cfg.instance_labels.values()}
    bool_void = np.isin(gt, np.asarray(cfg.void_ids))
    gflat = gt.reshape(-1)
    maxid = int(gflat.max()) + 1 if gflat.size else 1

    for pred_count, pred in enumerate(preds):
        name = cfg.instance_labels.get(int(pred["labelID"]))
        if name is None:
            continue
        mask = pred["mask"]
        bool_pred = np.asarray(mask) != 0
        pixel_count = int(np.count_nonzero(bool_pred))
        if pixel_count == 0:
            continue
        rec = {
            "predID": pred_count,
            "labelID": int(pred["labelID"]),
            "pixelCount": pixel_count,
            "confidence": float(pred["conf"]),
            "voidIntersection": int(np.count_nonzero(
                bool_void & bool_pred)),
        }
        # all gt intersections in one histogram
        hist = np.bincount(gflat[bool_pred.reshape(-1)], minlength=maxid)
        matched_gt = []
        for gt_num, g in enumerate(gt_instances[name]):
            inter = int(hist[g["instID"]]) if g["instID"] < maxid else 0
            if inter > 0:
                g_copy = {k: g[k] for k in
                          ("instID", "pixelCount", "is_group")}
                g_copy["intersection"] = inter
                p_copy = dict(rec)
                p_copy["intersection"] = inter
                matched_gt.append(g_copy)
                gt_instances[name][gt_num]["matchedPred"].append(p_copy)
        rec["matchedGt"] = matched_gt
        pred_instances[name].append(rec)
    return gt_instances, pred_instances


def _average_precision(y_true: np.ndarray, y_score: np.ndarray,
                       hard_fns: int) -> float:
    """Step-wise PR integration, exactly the benchmark's formulation."""
    order = np.argsort(y_score)
    y_score = y_score[order]
    y_true = y_true[order]
    cumsum = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    n_curve = len(unique_idx) + 1
    n_examples = len(y_score)
    n_true = cumsum[-1] if len(cumsum) else 0
    precision = np.zeros(n_curve)
    recall = np.zeros(n_curve)
    cumsum = np.append(cumsum, 0)
    for idx_res, idx_scores in enumerate(unique_idx):
        c = cumsum[idx_scores - 1]
        tp = n_true - c
        fp = n_examples - idx_scores - tp
        fn = c + hard_fns
        precision[idx_res] = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        recall[idx_res] = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    precision[-1] = 1.0
    recall[-1] = 0.0
    recall_conv = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def evaluate_matches(matches: Dict, cfg: InstanceEvalConfig) -> np.ndarray:
    """matches: {img: {'groundTruth':..., 'prediction':...}}.
    Returns ap[label, overlap]."""
    names = list(cfg.instance_labels.values())
    ap = np.zeros((len(names), len(cfg.overlaps)))
    for oi, overlap_th in enumerate(cfg.overlaps):
        for li, name in enumerate(names):
            y_true = []
            y_score = []
            hard_fns = 0
            have_gt = False
            have_pred = False
            for img in matches:
                preds = matches[img]["prediction"][name]
                gts = [g for g in matches[img]["groundTruth"][name]
                       if not g["is_group"]
                       and g["pixelCount"] >= cfg.min_region_size]
                if gts:
                    have_gt = True
                if preds:
                    have_pred = True

                cur_true = np.ones(len(gts))
                cur_score = np.full(len(gts), -np.inf)
                cur_match = np.zeros(len(gts), dtype=bool)
                for gi, g in enumerate(gts):
                    found = False
                    for p in g["matchedPred"]:
                        ov = p["intersection"] / (
                            g["pixelCount"] + p["pixelCount"]
                            - p["intersection"])
                        if ov > overlap_th:
                            conf = p["confidence"]
                            if cur_match[gi]:
                                mx = max(cur_score[gi], conf)
                                mn = min(cur_score[gi], conf)
                                cur_score[gi] = mx
                                cur_true = np.append(cur_true, 0)
                                cur_score = np.append(cur_score, mn)
                                cur_match = np.append(cur_match, True)
                            else:
                                found = True
                                cur_match[gi] = True
                                cur_score[gi] = conf
                    if not found:
                        hard_fns += 1
                cur_true = cur_true[cur_match]
                cur_score = cur_score[cur_match]

                for p in preds:
                    found_gt = False
                    for g in p["matchedGt"]:
                        if g["is_group"] or \
                                g["pixelCount"] < cfg.min_region_size:
                            continue
                        ov = g["intersection"] / (
                            g["pixelCount"] + p["pixelCount"]
                            - g["intersection"])
                        if ov > overlap_th:
                            found_gt = True
                            break
                    if not found_gt:
                        n_ignore = p["voidIntersection"]
                        for g in p["matchedGt"]:
                            if g["is_group"] or \
                                    g["pixelCount"] < cfg.min_region_size:
                                n_ignore += g["intersection"]
                        if n_ignore / p["pixelCount"] <= overlap_th:
                            cur_true = np.append(cur_true, 0)
                            cur_score = np.append(cur_score,
                                                  p["confidence"])
                y_true.append(cur_true)
                y_score.append(cur_score)

            if have_gt and have_pred:
                ap[li, oi] = _average_precision(
                    np.concatenate(y_true), np.concatenate(y_score),
                    hard_fns)
            elif have_gt:
                ap[li, oi] = 0.0
            else:
                ap[li, oi] = np.nan
    return ap


def _match_one(args):
    key, gt, preds, cfg = args
    gt_i, pred_i = match_image(np.asarray(gt), preds, cfg)
    return key, {"groundTruth": gt_i, "prediction": pred_i}


def evaluate_instances(gt_images: Dict[str, np.ndarray],
                       predictions: Dict[str, List[dict]],
                       cfg: Optional[InstanceEvalConfig] = None,
                       workers: int = 0):
    """Full evaluation from in-memory arrays.

    gt_images: {img_key: (H, W) instance-id array}.
    predictions: {img_key: [{'mask', 'labelID', 'conf'}]}.
    workers > 1 matches images in a forkserver process pool, like the
    reference's 4-process matcher
    (evalInstanceLevelSemanticLabeling.py:283-298); callers' scripts
    must use the standard `if __name__ == "__main__"` guard (forkserver
    re-imports the main module, the usual multiprocessing contract).
    Returns dict with 'allAp', 'allAp50', per-class APs.
    """
    cfg = cfg or InstanceEvalConfig()
    jobs = [(key, gt, predictions.get(key, []), cfg)
            for key, gt in gt_images.items()]
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp
        # forkserver, not fork: the caller usually holds a CUDA context
        # and threads (val-time AP eval), and forking such a process can
        # deadlock; jobs are plain picklable numpy/dataclass payloads
        with mp.get_context("forkserver").Pool(workers) as pool:
            matches = dict(pool.map(_match_one, jobs))
    else:
        matches = dict(_match_one(j) for j in jobs)
    ap = evaluate_matches(matches, cfg)
    names = list(cfg.instance_labels.values())
    overlaps = np.asarray(cfg.overlaps)
    o50 = np.isclose(overlaps, 0.5)
    res = {
        "classes": {},
    }
    for li, name in enumerate(names):
        if np.all(np.isnan(ap[li])):
            res["classes"][name] = {"ap": float("nan"),
                                    "ap50%": float("nan")}
        else:
            res["classes"][name] = {
                "ap": float(np.nanmean(ap[li])),
                "ap50%": float(np.nanmean(ap[li, o50])),
            }
    valid = ~np.all(np.isnan(ap), axis=1)
    res["allAp"] = float(np.nanmean(ap[valid])) if valid.any() else 0.0
    res["allAp50%"] = float(
        np.nanmean(ap[valid][:, o50])) if valid.any() else 0.0
    return res


def load_prediction_dir(result_dir: str, img_keys: Iterable[str]):
    """Read the reference's txt-manifest + mask-PNG format
    (`mask.png labelID conf` per line, ref cityscapes.py:276-281)."""
    predictions = {}
    for key in img_keys:
        txt = os.path.join(result_dir, key + ".txt")
        preds = []
        if os.path.exists(txt):
            with open(txt) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 3:
                        continue
                    mask_rel, label_id, conf = parts
                    mask = read_mask(os.path.join(result_dir, mask_rel))
                    preds.append({"mask": mask, "labelID": int(label_id),
                                  "conf": float(conf)})
        predictions[key] = preds
    return predictions
