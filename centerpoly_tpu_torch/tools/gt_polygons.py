"""Fixed-size polygon GT generation from Cityscapes-style polygon jsons.

The JAX package's tools/gt_polygons.py, with Pillow's fill in numpy
(geometry/pil_fill.py).  Reference:
cityscapesStuff/Tools/create_bouding_box_annotations.py
(:18-48 ray casting, :126-215 the three sampling schemes, csv row format
:143-215).  The reference walks Bresenham lines pixel-by-pixel in Python;
here each ray is sampled as a vectorized numpy index batch — identical
"first pixel inside the rasterized polygon" semantics, ~100x faster.

Schemes:
  regular_interval (shipped GT): N points evenly spaced along the bbox
    perimeter, each ray-cast toward the bbox center; vertex = first pixel
    inside the polygon mask.
  grid_based: N/2 vertical lines swept down then up.
  real_points: simplify/enrich the original polygon to exactly N vertices
    (delete shortest edges / split longest), rotated to start nearest the
    top-left corner.

Output CSV row (one object): path,x0,y0,x1,y1,label,count,x1,y1,...,xN,yN
where `count` is the per-image instance index with objects reversed —
bottom-most drawn last — which becomes the pseudo_depth draw-order target.
"""
from __future__ import annotations

import glob
import json
import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from ..geometry import pil_fill

# Cityscapes labels that have instances (reference :14)
HAVE_INSTANCES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle", "pole", "traffic sign", "traffic light",
]


def polygon_to_box(polygon: Sequence[Sequence[float]]) -> Tuple[float, ...]:
    """Axis-aligned bbox (x0, y0, x1, y1) of a vertex list."""
    p = np.asarray(polygon, dtype=np.float64)
    return (float(p[:, 0].min()), float(p[:, 1].min()),
            float(p[:, 0].max()), float(p[:, 1].max()))


def rasterize_polygon(polygon, height: int, width: int) -> np.ndarray:
    """uint8 mask (255 inside) of the filled polygon: Pillow's
    `polygon(fill=255, outline=0)`, as the reference draws it, so the
    border is erased after the fill."""
    img = np.zeros((height, width), np.uint8)
    return pil_fill.polygon(
        img, np.asarray(polygon, dtype=np.float64).reshape(-1, 2),
        fill=255, outline=0)


def perimeter_points(box, n_points: int) -> np.ndarray:
    """N points evenly spaced along the bbox perimeter, clockwise from the
    top-left corner: top edge, right edge, bottom edge (reversed), left edge
    (reversed).  n_points must be a multiple of 4 (reference :33-48)."""
    assert n_points % 4 == 0, "n_points must be a multiple of four"
    x0, y0, x1, y1 = box
    m = n_points // 4
    i = np.arange(m, dtype=np.float64)
    xi = (x1 - x0) / m
    yi = (y1 - y0) / m
    top = np.stack([np.round(x0 + i * xi), np.full(m, y0)], 1)
    right = np.stack([np.full(m, x1), np.round(y0 + i * yi)], 1)
    bottom = np.stack([np.round(x1 - i * xi), np.full(m, y1)], 1)
    left = np.stack([np.full(m, x0), np.round(y1 - i * yi)], 1)
    return np.concatenate([top, right, bottom, left], axis=0)


def _line_pixels(p0: np.ndarray, p1: np.ndarray, n: int) -> np.ndarray:
    """Integer pixels along each segment p0[k]->p1[k], shape (K, n, 2).

    Dense sampling at >= 1px steps covers the same pixel sequence as a
    Bresenham walk for the 'first hit' purpose (a hit can differ by at most
    the half-pixel rounding of the diagonal steps, identical in practice)."""
    t = np.linspace(0.0, 1.0, n)[None, :, None]          # (1, n, 1)
    pts = p0[:, None, :] * (1 - t) + p1[:, None, :] * t  # (K, n, 2)
    return np.round(pts).astype(np.int64)


def ray_cast_polygon(mask: np.ndarray, starts: np.ndarray,
                     targets: np.ndarray) -> np.ndarray:
    """For each ray start->target, the first pixel with mask>0.

    Falls back to the last sampled pixel when a ray never enters the mask
    (reference find_first_non_zero_pixel returns the final clipped pixel).
    All rays are vectorized as one gather.
    """
    h, w = mask.shape
    starts = np.asarray(starts, np.float64)
    targets = np.asarray(targets, np.float64)
    span = int(np.ceil(np.abs(targets - starts).max())) + 1
    n = max(span, 2)
    pix = _line_pixels(starts, targets, n)               # (K, n, 2)
    xs = np.clip(pix[..., 0], 0, w - 1)
    ys = np.clip(pix[..., 1], 0, h - 1)
    inside = mask[ys, xs] > 0                            # (K, n)
    first = np.argmax(inside, axis=1)                    # 0 if none
    has = inside.any(axis=1)
    idx = np.where(has, first, n - 1)
    k = np.arange(len(starts))
    return np.stack([xs[k, idx], ys[k, idx]], axis=1).astype(np.float64)


def _regular_interval(polygon, box, n_points, height, width):
    mask = rasterize_polygon(polygon, height, width)
    x0, y0, x1, y1 = box
    ct = np.array([int(x0 + (x1 - x0) / 2), int(y0 + (y1 - y0) / 2)],
                  dtype=np.float64)
    starts = perimeter_points(box, n_points)
    targets = np.broadcast_to(ct, starts.shape)
    return ray_cast_polygon(mask, starts, targets)


def _grid_based(polygon, box, n_points, height, width):
    """N/2 vertical grid lines swept top->bottom then bottom->top
    (reference :51-69, :170-180)."""
    assert n_points % 2 == 0
    mask = rasterize_polygon(polygon, height, width)
    x0, y0, x1, y1 = box
    x0, x1 = x0 + 1, x1 - 1
    m = n_points // 2
    xs = np.round(x0 + np.arange(m) * ((x1 - x0) / max(m - 1, 1)))
    down_s = np.stack([xs, np.full(m, y0)], 1)
    down_t = np.stack([xs, np.full(m, y1)], 1)
    up_s = np.stack([xs[::-1], np.full(m, y1)], 1)
    up_t = np.stack([xs[::-1], np.full(m, y0)], 1)
    return ray_cast_polygon(mask, np.concatenate([down_s, up_s]),
                            np.concatenate([down_t, up_t]))


def _real_points(polygon, box, n_points):
    """Resample the original vertex list to exactly N vertices: repeatedly
    drop the vertex ending the shortest edge / split the longest edge
    (reference :152-169), then rotate to start nearest (x0, y1).

    Note the reference anchors rotation at `bbox[0], bbox[2]` — with its
    (x0, y0, x1, y1) layout that is the (left, bottom) corner; preserved.
    """
    pts = [list(map(float, p)) for p in polygon]
    while len(pts) > n_points:
        d = [math.dist(pts[i - 1], pts[i]) for i in range(1, len(pts))]
        del pts[int(np.argmin(d))]
    while len(pts) < n_points:
        d = [math.dist(pts[i - 1], pts[i]) for i in range(1, len(pts))]
        j = int(np.argmax(d))
        mid = [int((pts[j][0] + pts[j + 1][0]) / 2),
               int((pts[j][1] + pts[j + 1][1]) / 2)]
        pts.insert(j + 1, mid)
    anchor = (box[0], box[2])
    d = [math.dist(p, anchor) for p in pts]
    k = int(np.argmin(d))
    return np.asarray(pts[k:] + pts[:k], dtype=np.float64)


def sample_polygon(polygon, n_points: int, method: str = "regular_interval",
                   height: int = 1024, width: int = 2048) -> np.ndarray:
    """Sample a GT polygon to exactly `n_points` vertices, shape (N, 2)."""
    box = polygon_to_box(polygon)
    if method == "regular_interval":
        return _regular_interval(polygon, box, n_points, height, width)
    if method == "grid_based":
        return _grid_based(polygon, box, n_points, height, width)
    if method == "real_points":
        return _real_points(polygon, box, n_points)
    raise ValueError(f"unknown sampling method '{method}'")


def generate_annotations(gt_json_path: str, image_path: str, n_points: int,
                         method: str = "regular_interval",
                         labels: Sequence[str] = tuple(HAVE_INSTANCES),
                         height: int = 1024, width: int = 2048,
                         data: dict | None = None) -> List[list]:
    """CSV rows for one Cityscapes `*_polygons.json` ground-truth file.

    Objects are processed in reverse annotation order so the per-image
    `count` index encodes draw order (bottom-most last = highest
    pseudo-depth), reference :143-215.  Pass `data` to reuse an
    already-parsed json (main() reads the file for imgHeight/imgWidth —
    re-parsing multi-MB polygon files doubles the tool's runtime).
    """
    if data is None:
        with open(gt_json_path) as f:
            data = json.load(f)
    objects = list(data["objects"])
    objects.reverse()
    rows = []
    count = 0
    for obj in objects:
        label = obj["label"]
        if label not in labels:
            continue
        box = polygon_to_box(obj["polygon"])
        pts = sample_polygon(obj["polygon"], n_points, method, height, width)
        row = [os.path.abspath(image_path), int(box[0]), int(box[1]),
               int(box[2]), int(box[3]), label, count]
        row += [int(v) for v in pts.reshape(-1)]
        rows.append(row)
        count += 1
    if count == 0:
        rows.append([os.path.abspath(image_path), -1, -1, -1, -1,
                     "no_object", 0])
    return rows


def main(argv=None):
    import argparse
    import csv

    ap = argparse.ArgumentParser(
        description="Generate fixed-size polygon GT CSVs from Cityscapes "
                    "gtFine polygon jsons")
    ap.add_argument("--data_dir", required=True,
                    help="root containing leftImg8bit/ and gtFine/")
    ap.add_argument("--split", default="train")
    ap.add_argument("--nbr_points", type=int, default=16)
    ap.add_argument("--method", default="regular_interval",
                    choices=["regular_interval", "grid_based", "real_points"])
    ap.add_argument("--out", required=True, help="output CSV path")
    ap.add_argument("--gt_kind", default="gtFine",
                    choices=["gtFine", "gtCoarse"])
    args = ap.parse_args(argv)

    pattern = os.path.join(args.data_dir, "leftImg8bit", args.split,
                           "*", "*.png")
    files = sorted(glob.glob(pattern))
    if not files:
        raise SystemExit(f"no images under {pattern}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        for img in files:
            gt = img.replace("leftImg8bit", args.gt_kind).replace(
                ".png", "_polygons.json")
            with open(gt) as fh:
                data = json.load(fh)
            rows = generate_annotations(
                gt, img, args.nbr_points, args.method,
                height=data.get("imgHeight", 1024),
                width=data.get("imgWidth", 2048), data=data)
            for r in rows:
                w.writerow(r)
    print(f"wrote {args.out} ({len(files)} images)")


if __name__ == "__main__":
    main()
