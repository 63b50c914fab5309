"""Pixel-level semantic labeling evaluation (official Cityscapes protocol):
the port's copy of the JAX package's eval/semantic_eval.py.

Re-implementation of the reference's vendored script (reference:
src/lib/datasets/evaluation/cityscapesscripts/evaluation/
evalPixelLevelSemanticLabeling.py:172-652): accumulate a label-id
confusion matrix over (prediction, ground-truth) image pairs, through
the native C++ loop in cpp/ where it builds (eval/native.py; ref
addToConfusionMatrix.pyx), numpy's bincount otherwise, then score

  * per-class IoU      tp / (tp + fp + fn), fp counted only over
                       not-ignored GT rows (ref :228-253),
  * per-category IoU   block sums over the category's valid labels
                       (ref :297-329),
  * instance-weighted iIoU for instance classes/categories, each GT
                       instance's tp/fn weighted by avgClassSize /
                       instSize (ref :549-652),
  * nan-aware averages (ref getScoreAverage :285-295).

Label ids follow the public Cityscapes benchmark definition (regular ids,
not train ids).  Host numpy; no entry point calls it, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .native import add_to_confusion_matrix


@dataclasses.dataclass(frozen=True)
class SemLabel:
    id: int
    name: str
    category: str
    has_instances: bool
    ignore_in_eval: bool


# The public Cityscapes label table (benchmark definition; regular ids).
SEMANTIC_LABELS: Tuple[SemLabel, ...] = (
    SemLabel(0, "unlabeled", "void", False, True),
    SemLabel(1, "ego vehicle", "void", False, True),
    SemLabel(2, "rectification border", "void", False, True),
    SemLabel(3, "out of roi", "void", False, True),
    SemLabel(4, "static", "void", False, True),
    SemLabel(5, "dynamic", "void", False, True),
    SemLabel(6, "ground", "void", False, True),
    SemLabel(7, "road", "flat", False, False),
    SemLabel(8, "sidewalk", "flat", False, False),
    SemLabel(9, "parking", "flat", False, True),
    SemLabel(10, "rail track", "flat", False, True),
    SemLabel(11, "building", "construction", False, False),
    SemLabel(12, "wall", "construction", False, False),
    SemLabel(13, "fence", "construction", False, False),
    SemLabel(14, "guard rail", "construction", False, True),
    SemLabel(15, "bridge", "construction", False, True),
    SemLabel(16, "tunnel", "construction", False, True),
    SemLabel(17, "pole", "object", False, False),
    SemLabel(18, "polegroup", "object", False, True),
    SemLabel(19, "traffic light", "object", False, False),
    SemLabel(20, "traffic sign", "object", False, False),
    SemLabel(21, "vegetation", "nature", False, False),
    SemLabel(22, "terrain", "nature", False, False),
    SemLabel(23, "sky", "sky", False, False),
    SemLabel(24, "person", "human", True, False),
    SemLabel(25, "rider", "human", True, False),
    SemLabel(26, "car", "vehicle", True, False),
    SemLabel(27, "truck", "vehicle", True, False),
    SemLabel(28, "bus", "vehicle", True, False),
    SemLabel(29, "caravan", "vehicle", True, True),
    SemLabel(30, "trailer", "vehicle", True, True),
    SemLabel(31, "train", "vehicle", True, False),
    SemLabel(32, "motorcycle", "vehicle", True, False),
    SemLabel(33, "bicycle", "vehicle", True, False),
)

ID2LABEL: Dict[int, SemLabel] = {l.id: l for l in SEMANTIC_LABELS}

# mean instance sizes the benchmark uses for the iIoU weighting
# (protocol constants, ref evalPixelLevelSemanticLabeling.py:147-158)
AVG_CLASS_SIZE = {
    "bicycle": 4672.3249222261, "caravan": 36771.8241758242,
    "motorcycle": 6298.7200839748, "rider": 3930.4788056518,
    "bus": 35732.1511111111, "train": 67583.7075812274,
    "car": 12794.0202738185, "person": 3462.4756337644,
    "truck": 27855.1264367816, "trailer": 16926.9763313609,
}


def _category2labels() -> Dict[str, List[SemLabel]]:
    out: Dict[str, List[SemLabel]] = {}
    for l in SEMANTIC_LABELS:
        out.setdefault(l.category, []).append(l)
    return out


CATEGORY2LABELS = _category2labels()
# categories whose labels (id >= 0) all have instances get an iIoU entry
INSTANCE_CATEGORIES = {
    cat: [l.id for l in ls]
    for cat, ls in CATEGORY2LABELS.items()
    if ls and all(l.has_instances for l in ls)
}


def accumulate_confusion(pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                         conf_matrix: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """Sum (prediction, ground-truth) label-id image pairs into a
    (34, 34) uint64 confusion matrix (rows = GT, cols = prediction)."""
    dim = max(ID2LABEL) + 1
    if conf_matrix is None:
        conf_matrix = np.zeros((dim, dim), np.uint64)
    for pred, gt in pairs:
        add_to_confusion_matrix(pred, gt, conf_matrix)
    return conf_matrix


def iou_score_for_label(label_id: int, conf: np.ndarray) -> float:
    """Ref getIouScoreForLabel (:228-253)."""
    lab = ID2LABEL[label_id]
    if lab.ignore_in_eval:
        return float("nan")
    tp = int(conf[label_id, label_id])
    fn = int(conf[label_id, :].sum()) - tp
    not_ignored = [l.id for l in SEMANTIC_LABELS
                   if not l.ignore_in_eval and l.id != label_id]
    fp = int(conf[not_ignored, label_id].sum())
    denom = tp + fp + fn
    return float(tp) / denom if denom else float("nan")


def iou_score_for_category(category: str, conf: np.ndarray) -> float:
    """Ref getIouScoreForCategory (:297-329)."""
    label_ids = [l.id for l in CATEGORY2LABELS.get(category, ())
                 if not l.ignore_in_eval]
    if not label_ids:
        return float("nan")
    block = conf[np.ix_(label_ids, label_ids)]
    tp = int(block.sum())
    fn = int(conf[label_ids, :].sum()) - tp
    other = [l.id for l in SEMANTIC_LABELS
             if not l.ignore_in_eval and l.category != category]
    fp = int(conf[np.ix_(other, label_ids)].sum())
    denom = tp + fp + fn
    return float(tp) / denom if denom else float("nan")


def score_average(scores: Dict[str, float]) -> float:
    """nan-aware mean (ref getScoreAverage :285-295)."""
    vals = [v for v in scores.values() if not np.isnan(v)]
    return float(np.mean(vals)) if vals else float("nan")


def _instance_stats(pairs) -> Dict[str, Dict]:
    """Weighted tp/fn per instance class and category
    (ref evaluatePair :602-652).  pairs: (pred, gt_instance_ids)."""
    classes = {l.name: {"tpWeighted": 0.0, "fnWeighted": 0.0}
               for l in SEMANTIC_LABELS
               if l.has_instances and not l.ignore_in_eval}
    categories = {c: {"tpWeighted": 0.0, "fnWeighted": 0.0,
                      "labelIds": ids}
                  for c, ids in INSTANCE_CATEGORIES.items()}
    for pred, inst in pairs:
        pred = np.asarray(pred)
        inst = np.asarray(inst)
        cat_masks = {c: np.isin(pred, np.asarray(v["labelIds"]))
                     for c, v in categories.items()}
        for inst_id in np.unique(inst[inst > 1000]):
            label = ID2LABEL[int(inst_id) // 1000]
            if label.ignore_in_eval:
                continue
            mask = inst == inst_id
            size = int(np.count_nonzero(mask))
            tp = int(np.count_nonzero(pred[mask] == label.id))
            weight = AVG_CLASS_SIZE[label.name] / float(size)
            classes[label.name]["tpWeighted"] += tp * weight
            classes[label.name]["fnWeighted"] += (size - tp) * weight
            if label.category in categories:
                cat_tp = int(np.count_nonzero(mask & cat_masks[label.category]))
                categories[label.category]["tpWeighted"] += cat_tp * weight
                categories[label.category]["fnWeighted"] += (
                    (size - cat_tp) * weight)
    return {"classes": classes, "categories": categories}


def _inst_iou_for_label(label_id: int, conf: np.ndarray,
                        stats: Dict) -> float:
    lab = ID2LABEL[label_id]
    if lab.ignore_in_eval or lab.name not in stats["classes"]:
        return float("nan")
    s = stats["classes"][lab.name]
    not_ignored = [l.id for l in SEMANTIC_LABELS
                   if not l.ignore_in_eval and l.id != label_id]
    fp = float(conf[not_ignored, label_id].sum())
    denom = s["tpWeighted"] + fp + s["fnWeighted"]
    return s["tpWeighted"] / denom if denom else float("nan")


def _inst_iou_for_category(category: str, conf: np.ndarray,
                           stats: Dict) -> float:
    if category not in stats["categories"]:
        return float("nan")
    s = stats["categories"][category]
    other = [l.id for l in SEMANTIC_LABELS
             if not l.ignore_in_eval and l.category != category]
    fp = float(conf[np.ix_(other, s["labelIds"])].sum())
    denom = s["tpWeighted"] + fp + s["fnWeighted"]
    return s["tpWeighted"] / denom if denom else float("nan")


def evaluate_semantic(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                      instance_pairs: Optional[Sequence[
                          Tuple[np.ndarray, np.ndarray]]] = None) -> Dict:
    """Score (prediction, GT labelIds) image pairs.

    Optionally pass instance_pairs as (prediction, GT instanceIds) to also
    get the benchmark's instance-weighted iIoU.  Returns the reference
    result dict shape: classScores / categoryScores (+Inst variants) and
    the four averageScore* fields (ref createResultDict :354-375).
    """
    conf = accumulate_confusion(pairs)
    class_scores = {l.name: iou_score_for_label(l.id, conf)
                    for l in SEMANTIC_LABELS}
    category_scores = {c: iou_score_for_category(c, conf)
                       for c in CATEGORY2LABELS}
    out = {
        "confMatrix": conf,
        "classScores": class_scores,
        "categoryScores": category_scores,
        "averageScoreClasses": score_average(class_scores),
        "averageScoreCategories": score_average(category_scores),
    }
    if instance_pairs is not None:
        stats = _instance_stats(instance_pairs)
        inst_class = {l.name: _inst_iou_for_label(l.id, conf, stats)
                      for l in SEMANTIC_LABELS}
        inst_cat = {c: _inst_iou_for_category(c, conf, stats)
                    for c in CATEGORY2LABELS}
        out["classInstScores"] = inst_class
        out["categoryInstScores"] = inst_cat
        out["averageScoreInstClasses"] = score_average(inst_class)
        out["averageScoreInstCategories"] = score_average(inst_cat)
    return out
