"""Synthetic datasets for smoke runs and tests: polygons in the Cityscapes
layout (`write_rect_fixture`), boxes in COCO's layout
(`write_box_fixture`) and person keypoints in COCO's layout
(`write_keypoint_fixture`).

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
box of a category drawn from `categories`.  Every annotation but each
fifth also carries the box's `extreme_points` (top, left, bottom, right,
each on its edge of the rectangle), which the exdet task reads; the
others exercise its fallback to the edge midpoints.

`write_keypoint_fixture` writes COCO person keypoints where CocoHpMeta
looks for them:

  <root>/coco/annotations/person_keypoints_<split>2017.json
  <root>/coco/images/<split>2017/img_<id>.npy (or .png)

1-4 persons a frame (category 1), each a filled rectangle with 17
(x, y, v) joints in it, each joint a bright 3x3 dot where visible: about
a fifth of the joints v = 0, a few placed outside the frame, and the
second person of the split with no visible joint.

`write_kitti3d_fixture` writes KITTI 3D boxes where KittiMeta looks for
them:

  <root>/kitti/annotations/kitti_3dop_<split>.json
  <root>/kitti/images/trainval/<id:06d>.png
  <root>/kitti/training/label_2/<id:06d>.txt

1242x375 RGB frames, each with 1 to `max_objects` objects of the
evaluated classes (Pedestrian 1, Car 2, Cyclist 3 in turn over the
split, so each has a third of them) and one other: Van 4, Person_sitting
5, Truck 6, Misc 7 or DontCare 9 in turn, so the sampler's ignore
branches (-3, -2, -1) and its skip (-99) all run.  (The KITTI evaluator
samples precision at 41 recall points: a class needs 41 objects or more
before its own boxes as results score AP 100.)  Each box is placed in camera
coordinates (depth 10-30 m, yaw anywhere), its 2D box the projection of
its corners through KITTI's calibration, at least 40 px tall, inside the
frame and clear of the others: with truncation and occlusion 0 every
object is "easy" for the KITTI evaluator.  The label files hold the same
numbers as the annotations, to two decimals.
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


def _extreme_points(rng, x0, y0, bw, bh) -> list:
    """A box's [t, l, b, r] extreme points, each at a random place on its
    edge: [[tx, ty], [lx, ly], [bx, by], [rx, ry]]."""
    return [[float(x0 + rng.randint(0, bw + 1)), float(y0)],
            [float(x0), float(y0 + rng.randint(0, bh + 1))],
            [float(x0 + rng.randint(0, bw + 1)), float(y0 + bh)],
            [float(x0 + bw), float(y0 + rng.randint(0, bh + 1))]]


def _write_frame(img_dir, name, img, png):
    if png:
        write_frame(os.path.join(img_dir, name), img)
    else:
        np.save(os.path.join(img_dir, name), img)


def write_box_fixture(root: str, counts: dict, seed: int, h: int = 480,
                      w: int = 640, categories=(1,), png: bool = False) -> str:
    """Write `counts[split]` frames of each split under `root` in COCO's
    layout (CocoMeta), boxes of the COCO category ids `categories`; image
    ids run on across the splits.  The extreme points come from a second
    generator, so frames and boxes do not depend on them.  Returns
    `root`."""
    rng = np.random.RandomState(seed)
    ext = np.random.RandomState(seed + 1)
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
                ann = {"id": len(annotations), "image_id": img_id,
                       "category_id": int(categories[rng.randint(
                           len(categories))]),
                       "bbox": [float(x0), float(y0), float(bw), float(bh)],
                       "area": float(bw * bh), "iscrowd": 0}
                if ann["id"] % 5 != 4:
                    ann["extreme_points"] = _extreme_points(ext, x0, y0, bw,
                                                            bh)
                annotations.append(ann)
            name = f"img_{img_id}.{'png' if png else 'npy'}"
            _write_frame(img_dir, name, img, png)
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


def write_keypoint_fixture(root: str, counts: dict, seed: int, h: int = 480,
                           w: int = 640, png: bool = False) -> str:
    """Write `counts[split]` frames of each split under `root` in COCO's
    person-keypoints layout (CocoHpMeta); image ids run on across the
    splits.  Returns `root`."""
    from .datasets import CocoHpMeta

    rng = np.random.RandomState(seed)
    meta = CocoHpMeta(root)
    img_id = 0
    for split, n in counts.items():
        img_dir = os.path.join(root, "coco", "images", f"{split}2017")
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        for _ in range(n):
            img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
            for _ in range(1 + int(rng.randint(0, 4))):
                bw = int(rng.randint(w // 10, w // 3))
                bh = int(rng.randint(h // 5, h // 2))
                x0 = int(rng.randint(2, w - bw - 3))
                y0 = int(rng.randint(2, h - bh - 3))
                img[y0:y0 + bh + 1, x0:x0 + bw + 1] = rng.randint(100, 180, 3)
                xs = x0 + rng.rand(17) * bw
                ys = y0 + rng.rand(17) * bh
                v = np.where(rng.rand(17) < 0.2, 0, 2)
                if len(annotations) == 1:
                    v[:] = 0
                elif rng.rand() < 0.3:
                    # a joint outside the frame, still labelled visible
                    j = int(rng.randint(17))
                    xs[j] = -6.0 if rng.rand() < 0.5 else w + 6.0
                for x, y, vis in zip(xs, ys, v):
                    xi, yi = int(x), int(y)
                    if vis and 1 <= xi < w - 1 and 1 <= yi < h - 1:
                        img[yi - 1:yi + 2, xi - 1:xi + 2] = 255
                kps = np.stack([xs, ys, v], 1).reshape(-1)
                annotations.append({
                    "id": len(annotations), "image_id": img_id,
                    "category_id": 1,
                    "bbox": [float(x0), float(y0), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0,
                    "keypoints": [float(k) for k in kps],
                    "num_keypoints": int((v > 0).sum())})
            name = f"img_{img_id}.{'png' if png else 'npy'}"
            _write_frame(img_dir, name, img, png)
            images.append({"id": img_id, "file_name": name, "height": h,
                           "width": w})
            img_id += 1
        path = meta.annot_path(split)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": 1, "name": "person"}]}, f)
    return root


KITTI_SIZE = (375, 1242)
# the reference's KITTI categories (ids 1-9) and their dimensions (h, w, l)
# in metres; DontCare has none
KITTI_CATEGORIES = {1: "Pedestrian", 2: "Car", 3: "Cyclist", 4: "Van",
                    5: "Person_sitting", 6: "Truck", 7: "Misc", 8: "Tram",
                    9: "DontCare"}
KITTI_DIMS = {1: (1.76, 0.66, 0.84), 2: (1.53, 1.63, 3.88),
              3: (1.74, 0.60, 1.76), 4: (2.21, 1.90, 5.08),
              5: (1.27, 0.59, 0.80), 6: (3.25, 2.59, 10.1),
              7: (1.91, 1.51, 3.58)}
KITTI_OTHERS = (4, 5, 9, 7, 6)


def _kitti_object(rng, cat, boxes, calib, h, w):
    """One object of category `cat` placed clear of `boxes`: (2D box
    [x0, y0, x1, y1], alpha, dim, location, rotation_y), rounded to two
    decimals; None after 200 tries."""
    from ..geometry.ddd import compute_box_3d, project_to_image

    for _ in range(200):
        if cat == 9:
            bw, bh = rng.uniform(40, 160), rng.uniform(40, 120)
            x0, y0 = rng.uniform(2, w - bw - 3), rng.uniform(2, h - bh - 3)
            box = np.round([x0, y0, x0 + bw, y0 + bh], 2)
            geo = (-10.0, (-1.0, -1.0, -1.0), (-1000.0, -1000.0, -1000.0),
                   -10.0)
        else:
            dim = np.round(np.asarray(KITTI_DIMS[cat])
                           * rng.uniform(0.9, 1.1, 3), 2)
            z = rng.uniform(10, 30)
            loc = np.round([rng.uniform(-0.35, 0.35) * z, 1.65, z], 2)
            ry = round(float(rng.uniform(-np.pi, np.pi)), 2)
            pts = project_to_image(compute_box_3d(dim, loc, ry), calib)
            box = np.round([*pts.min(0), *pts.max(0)], 2)
            alpha = ry - np.arctan2(loc[0], loc[2])
            alpha = round(float((alpha + np.pi) % (2 * np.pi) - np.pi), 2)
            geo = (alpha, tuple(dim), tuple(loc), ry)
        if (box[0] < 2 or box[1] < 2 or box[2] > w - 3 or box[3] > h - 3
                or box[3] - box[1] < 40):
            continue
        if any(box[0] < b[2] and b[0] < box[2] and box[1] < b[3]
               and b[1] < box[3] for b in boxes):
            continue
        return box, *geo
    return None


def write_kitti3d_fixture(root: str, counts: dict, seed: int,
                          max_objects: int = 3) -> str:
    """Write `counts[split]` frames of each split under `root` in KITTI's
    layout (KittiMeta, split 3dop); image ids run on across the splits.
    Returns `root`."""
    from ..geometry.ddd import DEFAULT_CALIB
    from .datasets import KittiMeta

    rng = np.random.RandomState(seed)
    meta = KittiMeta(root)
    h, w = KITTI_SIZE
    img_dir = os.path.join(root, "kitti", "images", "trainval")
    label_dir = os.path.join(root, "kitti", "training", "label_2")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    img_id = 0
    for split, n in counts.items():
        images, annotations = [], []
        for _ in range(n):
            img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
            n_obj = 1 + rng.randint(max_objects)
            cats = [1 + (len(annotations) + i) % 3 for i in range(n_obj)]
            cats.append(KITTI_OTHERS[img_id % len(KITTI_OTHERS)])
            boxes, lines = [], []
            for cat in cats:
                obj = _kitti_object(rng, cat, boxes, DEFAULT_CALIB, h, w)
                if obj is None:
                    continue
                box, alpha, dim, loc, ry = obj
                boxes.append(box)
                x0, y0, x1, y1 = (int(v) for v in box)
                img[y0:y1 + 1, x0:x1 + 1] = rng.randint(100, 256, 3)
                annotations.append({
                    "id": len(annotations), "image_id": img_id,
                    "category_id": cat,
                    "bbox": [float(box[0]), float(box[1]),
                             float(box[2] - box[0]), float(box[3] - box[1])],
                    "area": float((box[2] - box[0]) * (box[3] - box[1])),
                    "iscrowd": 0, "alpha": alpha, "depth": float(loc[2]),
                    "dim": [float(v) for v in dim],
                    "location": [float(v) for v in loc], "rotation_y": ry,
                    "truncated": 0, "occluded": 0})
                vals = [alpha, *box, *dim, *loc, ry]
                lines.append(f"{KITTI_CATEGORIES[cat]} 0.00 0 "
                             + " ".join(f"{float(v):.2f}" for v in vals))
            name = f"{img_id:06d}.png"
            write_frame(os.path.join(img_dir, name), img)
            with open(os.path.join(label_dir, f"{img_id:06d}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            images.append({"id": img_id, "file_name": name, "height": h,
                           "width": w, "calib": DEFAULT_CALIB.tolist()})
            img_id += 1
        path = meta.annot_path(split)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": i, "name": nm} for i, nm in
                                      KITTI_CATEGORIES.items()]}, f)
    return root
