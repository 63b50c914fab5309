"""run_eval harness: detections -> masks -> instance AP (the JAX
package's eval/harness.py; GT PNGs are read with utils/png.py).

Behavioral reference: dataset.run_eval (src/lib/datasets/dataset/
cityscapes.py:400-433): dump results.json, rasterize prediction masks, run
the official-protocol evaluator, return allAp.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import numpy as np

from ..utils.png import read_png
from .instance_eval import (InstanceEvalConfig, evaluate_instances,
                            gt_instances_from_image, load_prediction_dir)
from .rasterize import rasterize_results


def save_results_json(results: Dict, meta, save_dir: str):
    """results.json rows {image_id, category_id, polygon, score, depth}
    (ref cityscapes.py:147-169)."""
    detections = []
    for image_id, per_class in results.items():
        for cls_ind, rows in per_class.items():
            if cls_ind == "fg":
                continue
            for row in np.asarray(rows, np.float32).reshape(
                    -1, np.asarray(rows).shape[-1] if len(rows) else 1):
                detections.append({
                    "image_id": int(image_id),
                    "category_id": int(cls_ind),
                    "polygon": [round(float(v), 2) for v in row[5:-1]],
                    "score": round(float(row[4]), 2),
                    "depth": float(row[-1]),
                })
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "results.json"), "w") as f:
        json.dump(detections, f)


def run_instance_eval(meta, results: Dict, save_dir: str,
                      annotations=None,
                      gt_instance_dir: Optional[str] = None,
                      gt_images: Optional[Dict[str, np.ndarray]] = None,
                      thresh: float = 0.05):
    """Rasterize + evaluate. Returns allAp (and the full result dict).

    GT can come from in-memory arrays (`gt_images`, keyed like the mask
    manifests) or from a directory of *_instanceIds.png files.
    """
    save_results_json(results, meta, save_dir)
    res_dir = os.path.join(save_dir, "results")
    os.makedirs(res_dir, exist_ok=True)
    for f in glob.glob(os.path.join(res_dir, "*.txt")):
        os.remove(f)
    for f in glob.glob(os.path.join(res_dir, "*", "*.png")):
        os.remove(f)

    if annotations is not None:
        id_to_file = {int(i): im["file_name"]
                      for i, im in annotations.imgs.items()}
    else:
        id_to_file = {int(i): f"{i}.png" for i in results}
    rasterize_results(results, meta, res_dir, id_to_file, thresh=thresh)

    if gt_images is None and gt_instance_dir is not None:
        gt_images = {}
        for image_id in results:
            name = os.path.basename(id_to_file[int(image_id)])
            stem = os.path.splitext(name)[0]
            # cityscapes naming: <city>_<seq>_<frame>_leftImg8bit.png ->
            # <city>_<seq>_<frame>_gtFine_instanceIds.png
            gt_name = stem.replace("leftImg8bit", "gtFine_instanceIds") \
                + ".png"
            matches = glob.glob(os.path.join(gt_instance_dir, "**",
                                             gt_name), recursive=True)
            if matches:
                gt_images[stem] = read_png(matches[0])
    if not gt_images:
        return None

    keys = list(gt_images.keys())
    predictions = load_prediction_dir(res_dir, keys)
    cfg = InstanceEvalConfig()
    if getattr(meta, "instance_labels", None):
        cfg.instance_labels = dict(meta.instance_labels)
    if getattr(meta, "void_ids", None):
        cfg.void_ids = tuple(meta.void_ids)
    res = evaluate_instances(gt_images, predictions, cfg=cfg,
                             workers=min(4, os.cpu_count() or 1))
    res_path = os.path.join(save_dir, "instance_ap.json")
    with open(res_path, "w") as f:
        json.dump(res, f, indent=2)

    # gtInstances.json cache artifact (ref evalInstanceLevelSemantic
    # Labeling.py:196-212): per-image instance stats, written once so
    # repeated evals / external tools can skip re-scanning the GT pngs
    gti_path = os.path.join(save_dir, "gtInstances.json")
    if not os.path.exists(gti_path):
        cache = {k: gt_instances_from_image(np.asarray(v), cfg)
                 for k, v in gt_images.items()}
        with open(gti_path, "w") as f:
            json.dump(cache, f)
    return res
