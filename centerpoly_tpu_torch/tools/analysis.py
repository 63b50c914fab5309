"""Offline analysis tools (the JAX package's tools/analysis.py), with no
cv2, Pillow or matplotlib needed for a result: masks and frames through
utils/png.py, the contours through tools/contours.py, the fills through
geometry/pil_fill.py, the overlays through utils/debugger.py.  Only
`plot_training_log` draws with matplotlib, imported inside it, and
returns [] where it is missing, as in the JAX package.

Reference surfaces:
  * src/tools/eval_coco.py — score a results.json against COCO GT;
  * src/tools/calc_coco_overlap.py — how well N-vertex polygon
    approximations cover the original instance masks (GT quality study);
  * src/tools/postprocessing_disks.py — simplify predicted masks into
    polygons via Douglas-Peucker contours;
  * src/tools/vis_pred.py — overlay results.json predictions on images.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from ..geometry import pil_fill
from ..utils.png import read_image, read_png, write_png
from . import contours


def eval_coco_results(gt_json: str, results_json: str) -> Dict[str, float]:
    """Score a COCO-format detection results file (ref eval_coco.py).

    results_json rows: {image_id, category_id, bbox [x, y, w, h], score}.
    """
    from ..data.coco_poly import CocoPolyAnnotations
    from ..eval.coco_eval import evaluate_coco_map

    ann = CocoPolyAnnotations(gt_json)
    with open(results_json) as f:
        rows = json.load(f)
    per_img: Dict[int, Dict[int, list]] = {}
    for r in rows:
        x, y, w, h = r["bbox"]
        per_img.setdefault(int(r["image_id"]), {}).setdefault(
            int(r["category_id"]), []).append(
            [x, y, x + w, y + h, r["score"]])
    results = {i: {c: np.asarray(v, np.float32) for c, v in pc.items()}
               for i, pc in per_img.items()}
    return evaluate_coco_map(ann, results)


def polygon_coverage(gt_json: str, n_points: int = 16,
                     method: str = "regular_interval",
                     max_images: Optional[int] = None) -> Dict[str, float]:
    """Mean IoU between each GT mask and its N-vertex polygon
    approximation (ref calc_coco_overlap.py's study, rebuilt on the
    ray-cast sampler from tools/gt_polygons)."""
    from ..data.coco_poly import CocoPolyAnnotations
    from .gt_polygons import sample_polygon, rasterize_polygon

    ann = CocoPolyAnnotations(gt_json)
    ious = []
    for count, img_id in enumerate(ann.get_img_ids()):
        if max_images is not None and count >= max_images:
            break
        info = ann.load_img(img_id)
        # csv_coco-generated jsons (like the reference's) omit
        # height/width — default to the cityscapes frame, NOT 512x512,
        # or every polygon beyond pixel 512 silently rasterizes clipped
        # and the coverage number is wrong
        h = int(info.get("height", 1024))
        w = int(info.get("width", 2048))
        for a in ann.load_anns(img_id):
            seg = a.get("segmentation") or (
                [a["poly"]] if "poly" in a else None)
            if not seg or not isinstance(seg, list):
                continue
            orig = np.asarray(seg[0], np.float32).reshape(-1, 2)
            if len(orig) < 3:
                continue
            gt_mask = rasterize_polygon(orig, h, w)
            approx = sample_polygon(orig, n_points, method=method,
                                    height=h, width=w)
            ap_mask = rasterize_polygon(
                np.asarray(approx, np.float32).reshape(-1, 2), h, w)
            inter = np.logical_and(gt_mask, ap_mask).sum()
            union = np.logical_or(gt_mask, ap_mask).sum()
            if union > 0:
                ious.append(inter / union)
    ious = np.asarray(ious, np.float64)
    return {"mean_iou": float(ious.mean()) if len(ious) else 0.0,
            "n": int(len(ious))}


def _read_gray(path: str) -> np.ndarray:
    """cv2.imread(path, cv2.IMREAD_GRAYSCALE) of a gray PNG: 8-bit as it
    is, 16-bit by its high byte.  A colour PNG raises ValueError: cv2
    turns it gray through libpng's weighting, which is not reproduced
    here."""
    a = read_png(path)
    if a.ndim != 2:
        raise ValueError(f"{path}: expected a gray mask PNG, got {a.shape}")
    return (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a


def simplify_masks(mask_dir: str, out_dir: str,
                   alpha: float = 0.001) -> float:
    """Douglas-Peucker polygon simplification of binary mask PNGs
    (ref postprocessing_disks.py): each mask's outer contours, each cut
    to eps = alpha x its perimeter, filled (outline erased) into a new
    mask of the same name.  Files that are not `.png` are skipped.
    Returns mean seconds per image."""
    os.makedirs(out_dir, exist_ok=True)
    total, count = 0.0, 0
    for name in sorted(os.listdir(mask_dir)):
        path = os.path.join(mask_dir, name)
        if not (name.lower().endswith(".png") and os.path.isfile(path)):
            continue
        img = _read_gray(path)
        count += 1
        t0 = time.time()
        found = contours.find_external_contours(img)
        im = np.zeros(img.shape[:2], np.uint8)
        for cnt in found:
            eps = alpha * contours.arc_length(cnt, True)
            approx = contours.approx_poly_dp(cnt, eps)
            poly = [(int(p[0][0]), int(p[0][1])) for p in approx]
            if len(poly) > 1:
                pil_fill.polygon(im, poly, fill=255, outline=0)
        total += time.time() - t0
        write_png(os.path.join(out_dir, name), im)
    return total / max(count, 1)


def visualize_results(results_json: str, img_dir: str, out_dir: str,
                      vis_thresh: float = 0.3,
                      id_to_file: Optional[Dict[int, str]] = None):
    """Overlay results.json polygons on their source images
    (ref vis_pred.py).  Frames are read by utils/png.py::read_image (PNG
    and .npy in numpy) and written as PNG, under the frame's name with a
    .png extension; a missing frame is skipped."""
    from ..utils.debugger import Debugger
    from ..utils.png import write_frame

    with open(results_json) as f:
        rows = json.load(f)
    per_img: Dict[int, list] = {}
    for r in rows:
        per_img.setdefault(int(r["image_id"]), []).append(r)

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for img_id, dets in per_img.items():
        name = id_to_file[img_id] if id_to_file else f"{img_id}.png"
        path = os.path.join(img_dir, name)
        if not os.path.isfile(path):
            continue
        img = read_image(path)
        dbg = Debugger(num_classes=32)
        dbg.add_img(img, "vis")
        for d in dets:
            if d["score"] < vis_thresh:
                continue
            dbg.add_polydet(d["polygon"], d["category_id"], d["score"],
                            img_id="vis")
        out_path = os.path.join(
            out_dir, os.path.splitext(os.path.basename(name))[0] + ".png")
        write_frame(out_path, dbg.imgs["vis"])
        written.append(out_path)
    return written


def parse_training_log(log_path: str):
    """Parse a Logger log.txt into per-metric series
    (ref src/tools/create_graphs_log.py, which slices the reference's
    epoch lines by fixed offsets; here the trainer's `k v` pairs are
    parsed by name so new loss terms need no tool change).

    Returns (train, val): each {metric: [(epoch, value), ...]}.
    Trainer lines (utils/logger.py prepends a timestamp):
        <ts>: epoch N | n iters | Ts | loss 1.2 hm_loss 0.8 ...
        <ts>: val   N | loss 1.3 ...
    """
    train: Dict[str, list] = {}
    val: Dict[str, list] = {}
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            # strip the logger timestamp prefix if present
            for marker in ("epoch ", "val   ", "val "):
                i = line.find(marker)
                if i >= 0:
                    line = line[i:]
                    break
            else:
                continue
            parts = [p.strip() for p in line.split("|")]
            head = parts[0].split()
            if len(head) < 2 or not head[1].isdigit():
                continue
            epoch = int(head[1])
            dest = train if head[0] == "epoch" else val
            kv = parts[-1].split()
            if len(kv) < 2 or kv[0] == "AP":
                continue
            for k, v in zip(kv[0::2], kv[1::2]):
                try:
                    dest.setdefault(k, []).append((epoch, float(v)))
                except ValueError:
                    continue
    return train, val


def plot_training_log(log_path: str, out_prefix: str = "loss"):
    """Plot train/val loss curves from a log.txt
    (ref create_graphs_log.py writes loss_train.png / loss_valid.png).

    Returns the list of files written; no-op (returns []) when
    matplotlib is unavailable.
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return []
    train, val = parse_training_log(log_path)
    written = []
    for series, tag in ((train, "train"), (val, "valid")):
        if not series:
            continue
        plt.figure()
        for k, pts in sorted(series.items()):
            xs = [e for e, _ in pts]
            ys = [v for _, v in pts]
            plt.plot(xs, ys, label=k)
        plt.xlabel("epoch")
        plt.legend()
        out = f"{out_prefix}_{tag}.png"
        plt.savefig(out)
        plt.close()
        written.append(out)
    return written


def merge_coco_json(input_paths, output_path: str) -> Dict[str, int]:
    """Merge COCO-format annotation files into one
    (ref src/tools/merge_pascal_json.py; categories/type come from the
    first file).

    Unlike the original's count-based offset (which collides for
    non-contiguous annotation ids and silently keeps duplicate image
    ids), both image and annotation ids are REASSIGNED sequentially and
    every annotation's image_id is remapped through its own file's
    image-id map — collision-free for any inputs.

    Returns {'images': n, 'annotations': n} of the merged file.
    """
    out: Dict[str, object] = {"images": [], "annotations": []}
    next_img = 1
    next_ann = 1
    for i, path in enumerate(input_paths):
        with open(path) as f:
            data = json.load(f)
        if i == 0:
            for key in ("type", "categories"):
                if key in data:
                    out[key] = data[key]
        img_map = {}
        for img in data.get("images", []):
            img = dict(img)
            img_map[img["id"]] = next_img
            img["id"] = next_img
            next_img += 1
            out["images"].append(img)
        for ann in data.get("annotations", []):
            ann = dict(ann)
            ann["id"] = next_ann
            next_ann += 1
            ann["image_id"] = img_map[ann["image_id"]]
            out["annotations"].append(ann)
    with open(output_path, "w") as f:
        json.dump(out, f)
    return {"images": len(out["images"]),
            "annotations": len(out["annotations"])}
