"""A synthetic dataset in the Cityscapes layout, for smoke runs and tests.

Frames are `.npy` (H, W, 3) uint8: dark noise with 1-3 filled rectangles,
each annotated as a 16-vertex polygon along its perimeter, class `car`
(the JAX package's experiments/train_convergence.py fixture).  Written as

  <root>/leftImg8bit/<split>/img_<i>.npy
  <root>/cityscapesStuff/BBoxes/<split><N>_regular_interval.json

for every split asked for, the same frames in each, so CityscapesMeta
finds them.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .datasets import CityscapesMeta


def rect_poly(x0, y0, w, h, n=16) -> np.ndarray:
    """n vertices along a rectangle's perimeter, clockwise from (x0, y0)."""
    pts, per, d = [], 2 * (w + h), 0.0
    for _ in range(n):
        t = d % per
        if t < w:
            pts.append((x0 + t, y0))
        elif t < w + h:
            pts.append((x0 + w, y0 + (t - w)))
        elif t < 2 * w + h:
            pts.append((x0 + w - (t - w - h), y0 + h))
        else:
            pts.append((x0, y0 + h - (t - 2 * w - h)))
        d += per / n
    return np.array(pts, np.float32)


def write_rect_fixture(root: str, n_images: int, seed: int, h: int = 1024,
                       w: int = 2048, n_points: int = 16,
                       splits=("train",)) -> str:
    """Write the fixture under `root`; returns `root`."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    frames = []
    for i in range(n_images):
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        for k in range(1 + int(rng.randint(0, 3))):
            bw = int(rng.randint(w // 8, w // 3))
            bh = int(rng.randint(h // 6, h // 2))
            x0 = int(rng.randint(2, w - bw - 3))
            y0 = int(rng.randint(2, h - bh - 3))
            img[y0:y0 + bh + 1, x0:x0 + bw + 1] = rng.randint(140, 256, 3)
            annotations.append({
                "id": len(annotations), "image_id": i, "category_id": 3,
                "bbox": [float(x0), float(y0), float(bw), float(bh)],
                "poly": rect_poly(x0, y0, bw, bh, n_points).reshape(-1)
                .tolist(),
                "pseudo_depth": k, "area": float(bw * bh)})
        images.append({"id": i, "file_name": f"img_{i}.npy",
                       "height": h, "width": w})
        frames.append(img)
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": c, "name": n} for c, n in
                          enumerate(CityscapesMeta.class_name[1:9], 1)]}
    meta = CityscapesMeta(root, n_points)
    for split in splits:
        img_dir = os.path.join(root, "leftImg8bit", split)
        os.makedirs(img_dir, exist_ok=True)
        for i, img in enumerate(frames):
            np.save(os.path.join(img_dir, f"img_{i}.npy"), img)
        path = meta.annot_path(split)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(ann, f)
    return root
