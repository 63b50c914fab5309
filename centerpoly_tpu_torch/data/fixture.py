"""Synthetic datasets for smoke runs and tests: polygons in the Cityscapes
layout (`write_rect_fixture`) and boxes in a box dataset's layout
in COCO's layout (`write_box_fixture`).

Frames are `.npy` (H, W, 3) uint8: dark noise with 1-3 filled rectangles,
each annotated as a 16-vertex polygon along its perimeter, class `car`
(the JAX package's experiments/train_convergence.py fixture).  Written as

  <root>/leftImg8bit/<split>/img_<i>.npy
  <root>/cityscapesStuff/BBoxes/<split><N>_regular_interval.json

for every split asked for, the same frames in each, so CityscapesMeta
finds them.  With `png=True` the frames are PNG under the Cityscapes names
the eval path needs (the GT lookup and the mask names derive from them),
with 16-bit GT instance ids (car = 26000 + k, painted in the frame's own
order, later rectangles over earlier ones):

  <root>/leftImg8bit/<split>/synth/synth_<i:06d>_000019_leftImg8bit.png
  <root>/gtFine/<split>/synth/synth_<i:06d>_000019_gtFine_instanceIds.png

The pixels are the same as the `.npy` fixture's of the same seed.

`write_box_fixture` writes COCO-format box annotations in COCO's layout,
where CocoMeta looks for them:

  <root>/coco/annotations/instances_<split>2017.json
  <root>/coco/images/<split>2017/img_<id>.npy (or .png)

each split its own frames: dark noise with 1-5 filled rectangles, each one
box of a category drawn from `categories`.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils.png import write_frame, write_png
from .datasets import CityscapesMeta, CocoMeta

CITY = "synth"


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
                       splits=("train",), png: bool = False) -> str:
    """Write the fixture under `root`; returns `root`."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    frames, gts = [], []
    for i in range(n_images):
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        gt = np.zeros((h, w), np.uint16)
        for k in range(1 + int(rng.randint(0, 3))):
            bw = int(rng.randint(w // 8, w // 3))
            bh = int(rng.randint(h // 6, h // 2))
            x0 = int(rng.randint(2, w - bw - 3))
            y0 = int(rng.randint(2, h - bh - 3))
            img[y0:y0 + bh + 1, x0:x0 + bw + 1] = rng.randint(140, 256, 3)
            gt[y0:y0 + bh + 1, x0:x0 + bw + 1] = 26000 + k
            annotations.append({
                "id": len(annotations), "image_id": i, "category_id": 3,
                "bbox": [float(x0), float(y0), float(bw), float(bh)],
                "poly": rect_poly(x0, y0, bw, bh, n_points).reshape(-1)
                .tolist(),
                "pseudo_depth": k, "area": float(bw * bh)})
        name = (f"{CITY}/{CITY}_{i:06d}_000019_leftImg8bit.png" if png
                else f"img_{i}.npy")
        images.append({"id": i, "file_name": name, "height": h, "width": w})
        frames.append(img)
        gts.append(gt)
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": c, "name": n} for c, n in
                          enumerate(CityscapesMeta.class_name[1:9], 1)]}
    meta = CityscapesMeta(root, n_points)
    for split in splits:
        img_dir = os.path.join(root, "leftImg8bit", split)
        os.makedirs(img_dir, exist_ok=True)
        for im, img, gt in zip(images, frames, gts):
            if not png:
                np.save(os.path.join(img_dir, im["file_name"]), img)
                continue
            path = os.path.join(img_dir, im["file_name"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_frame(path, img)
            gt_path = os.path.join(
                root, "gtFine", split, im["file_name"].replace(
                    "leftImg8bit", "gtFine_instanceIds"))
            os.makedirs(os.path.dirname(gt_path), exist_ok=True)
            write_png(gt_path, gt)
        path = meta.annot_path(split)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(ann, f)
    return root


def write_box_fixture(root: str, counts: dict, seed: int, h: int = 480,
                      w: int = 640, categories=(1,), png: bool = False) -> str:
    """Write `counts[split]` frames of each split under `root` in COCO's
    layout (CocoMeta), boxes of the COCO category ids `categories`; image
    ids run on across the splits.  Returns `root`."""
    rng = np.random.RandomState(seed)
    meta = CocoMeta(root)
    img_id = 0
    for split, n in counts.items():
        img_dir = os.path.join(root, "coco", "images", f"{split}2017")
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        for _ in range(n):
            img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
            for _ in range(1 + int(rng.randint(0, 5))):
                bw = int(rng.randint(w // 10, w // 3))
                bh = int(rng.randint(h // 10, h // 2))
                x0 = int(rng.randint(2, w - bw - 3))
                y0 = int(rng.randint(2, h - bh - 3))
                img[y0:y0 + bh + 1, x0:x0 + bw + 1] = rng.randint(140, 256, 3)
                annotations.append({
                    "id": len(annotations), "image_id": img_id,
                    "category_id": int(categories[rng.randint(
                        len(categories))]),
                    "bbox": [float(x0), float(y0), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0})
            name = f"img_{img_id}.{'png' if png else 'npy'}"
            if png:
                write_frame(os.path.join(img_dir, name), img)
            else:
                np.save(os.path.join(img_dir, name), img)
            images.append({"id": img_id, "file_name": name, "height": h,
                           "width": w})
            img_id += 1
        path = meta.annot_path(split)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [
                           {"id": c, "name": meta.class_name[meta.cat_ids[c] + 1]}
                           for c in sorted(set(categories))]}, f)
    return root
