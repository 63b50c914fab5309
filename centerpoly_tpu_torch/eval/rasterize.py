"""Prediction-mask rendering for instance-segmentation eval (the JAX
package's eval/rasterize.py; reference
src/lib/datasets/dataset/cityscapes.py:196-283, format_and_write_to_
cityscapes): for every detection above the threshold, rasterize the
polygon at full resolution, thicken the contour with Bresenham lines and
radius-2 disks at each contour pixel, process instances in pseudo-depth
order, take out pixels already claimed by earlier masks of score >= 0.5,
drop excluded classes and regions of 100 px or less, and write one PNG per
instance and a txt manifest `mask.png labelID min(1, score*1.2)`.

The masks are byte-equal to the JAX package's, which draws with Pillow;
here in numpy:

  * the fill is Pillow's rule, even-odd, on rows at integer y, so a
    self-crossing polygon (a pentagram) keeps its centre empty.  Pillow
    ties a pixel lying on an edge in its own way; every such pixel lies
    within a disk of the thickened contour, so the mask does not depend on
    the tie;
  * the disk is Pillow's ellipse of radius 2: the 5x5 square without its
    four corners (21 px);
  * `bresenham_line` gives the JAX loop's points in closed form, and only
    the part of a line within 2 px of the frame is generated: vertices of
    a random net can lie thousands of pixels off it;
  * each instance is drawn inside its polygon's bounding box clipped to
    the frame, and written out at full size.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.png import write_png

# Pillow's ellipse [(x-2, y-2), (x+2, y+2)]: the 5x5 square minus corners
_DISK = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
         if abs(dy) + abs(dx) < 4]
_RADIUS = 2


def _line_points(x0: int, y0: int, x1: int, y1: int, band=None):
    """The points of the JAX package's `bresenham_line`, as int64 arrays
    (xs, ys) in walking order.  Along the major axis, step i moves by
    exactly one; the minor axis has then moved ceil(i*minor/major - 1/2)
    (the error term's rounding).  `band` (x_lo, x_hi, y_lo, y_hi): keep
    only the points inside it, generating no point off its major-axis
    range."""
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    x_major = dx >= dy
    major, minor = (dx, dy) if x_major else (dy, dx)
    lo, hi = 0, major
    if band is not None:
        b_lo, b_hi = band[:2] if x_major else band[2:]
        start, s = (x0, sx) if x_major else (y0, sy)
        # start + s*i within [b_lo, b_hi]
        i_a, i_b = (b_lo - start, b_hi - start) if s > 0 else \
            (start - b_hi, start - b_lo)
        lo, hi = max(lo, i_a), min(hi, i_b)
    i = np.arange(lo, hi + 1, dtype=np.int64)
    if major == 0:
        step = np.zeros_like(i)
    else:       # ceil((2 i minor - major) / (2 major)), exact in integers
        step = -((major - 2 * i * minor) // (2 * major))
    if x_major:
        xs, ys = x0 + sx * i, y0 + sy * step
    else:
        xs, ys = x0 + sx * step, y0 + sy * i
    if band is not None:
        keep = ((xs >= band[0]) & (xs <= band[1])
                & (ys >= band[2]) & (ys <= band[3]))
        xs, ys = xs[keep], ys[keep]
    return xs, ys


def bresenham_line(x0: int, y0: int, x1: int, y1: int
                   ) -> List[Tuple[int, int]]:
    """Integer line rasterization: the points from (x0, y0) to (x1, y1)."""
    xs, ys = _line_points(int(x0), int(y0), int(x1), int(y1))
    return list(zip(xs.tolist(), ys.tolist()))


def _fill_even_odd(px: np.ndarray, py: np.ndarray, box) -> np.ndarray:
    """Even-odd fill of the closed polygon (px, py) on the rows and columns
    of `box` (y0, y1, x0, x1, end-exclusive), sampled at integer
    coordinates: a pixel is in when an odd number of edge crossings of its
    row lie at or left of it.  An edge spans the rows [min y, max y)."""
    y0, y1, x0, x1 = box
    qx, qy = np.roll(px, -1), np.roll(py, -1)
    keep = py != qy                                 # horizontal edges: none
    ax, ay, bx, by = px[keep], py[keep], qx[keep], qy[keep]
    bw = x1 - x0
    out = np.zeros((y1 - y0, bw), bool)
    if ax.size == 0 or bw <= 0 or y1 <= y0:
        return out
    rows = np.arange(y0, y1, dtype=np.int64)[:, None]
    lo, hi = np.minimum(ay, by), np.maximum(ay, by)
    cross = (rows >= lo) & (rows < hi)
    xc = ax + (rows - ay) * ((bx - ax) / (by - ay))
    col = np.clip(np.ceil(xc) - x0, 0, bw).astype(np.int64)
    r, e = np.nonzero(cross)
    counts = np.bincount(r * (bw + 1) + col[r, e],
                         minlength=(y1 - y0) * (bw + 1))
    parity = np.cumsum(counts.reshape(y1 - y0, bw + 1)[:, :bw], axis=1) & 1
    return parity.astype(bool)


def _render_box(points: Sequence[Tuple[int, int]], h: int, w: int):
    """The mask of one polygon inside its bounding box clipped to the
    frame: (bool (y1-y0, x1-x0) array, (y0, y1, x0, x1)); None when the
    polygon and its contour disks miss the frame."""
    pts = np.asarray(points, np.int64).reshape(-1, 2)
    px, py = pts[:, 0], pts[:, 1]
    y0 = max(0, int(py.min()) - _RADIUS)
    y1 = min(h, int(py.max()) + _RADIUS + 1)
    x0 = max(0, int(px.min()) - _RADIUS)
    x1 = min(w, int(px.max()) + _RADIUS + 1)
    if y1 <= y0 or x1 <= x0:
        return None
    box = (y0, y1, x0, x1)
    mask = _fill_even_odd(px, py, box)
    band = (-_RADIUS, w - 1 + _RADIUS, -_RADIUS, h - 1 + _RADIUS)
    segs = [_line_points(int(px[i - 1]), int(py[i - 1]), int(px[i]),
                         int(py[i]), band) for i in range(len(px))]
    cx = np.concatenate([s[0] for s in segs]) - x0
    cy = np.concatenate([s[1] for s in segs]) - y0
    bh, bw = y1 - y0, x1 - x0
    for ddy, ddx in _DISK:
        yy, xx = cy + ddy, cx + ddx
        inside = (yy >= 0) & (yy < bh) & (xx >= 0) & (xx < bw)
        mask[yy[inside], xx[inside]] = True
    return mask, box


def render_instance_mask(points: Sequence[Tuple[int, int]], size_wh
                         ) -> np.ndarray:
    """Filled polygon + thickened contour as a (h, w) uint8 array of 0 /
    255 (ref :253-264; the JAX function's image as an array)."""
    w, h = size_wh
    out = np.zeros((h, w), np.uint8)
    drawn = _render_box(points, h, w)
    if drawn is not None:
        mask, (y0, y1, x0, x1) = drawn
        out[y0:y1, x0:x1][mask] = 255
    return out


def rasterize_results(results_per_image: Dict, meta, save_dir: str,
                      id_to_file: Dict[int, str], thresh: float = 0.05):
    """Write eval-format masks + manifests for every image.

    results_per_image: {image_id: {class_ind: (n, 5+2N+1) array-likes}}
      rows [x0, y0, x1, y1, score, poly..., depth] in source coords.
    meta: DatasetMeta (eval_image_size, class_name, label_to_id,
      eval_drop_classes).
    """
    h, w = meta.eval_image_size
    masks_dir = os.path.join(save_dir, "masks")
    os.makedirs(masks_dir, exist_ok=True)

    for image_id, per_class in results_per_image.items():
        image_name = id_to_file[int(image_id)]
        base = os.path.basename(image_name)
        txt_path = os.path.join(save_dir,
                                base.replace(".png", ".txt").replace(
                                    ".jpg", ".txt"))
        lines = []
        to_remove = np.zeros((h, w), bool)
        params = []
        for cls_ind, rows in per_class.items():
            if cls_ind == "fg":
                continue
            label = meta.class_name[int(cls_ind)]
            for row in np.asarray(rows, dtype=np.float32).reshape(
                    -1, np.asarray(rows).shape[-1] if len(rows) else 1):
                if row[4] > thresh:
                    depth = row[-1]
                    poly = row[5:-1]
                    points = [(int(x), int(y))
                              for x, y in zip(poly[0::2], poly[1::2])]
                    params.append((points, float(row[4]), label,
                                   float(depth)))

        count = 0
        # draw order: ascending pseudo-depth, stable (ref :239)
        for points, score, label, depth in sorted(params,
                                                  key=lambda a: a[-1]):
            # drop-class polygons are never drawn (cityscapes.py:242), so
            # they carve nothing out of later instances either
            if label in meta.eval_drop_classes:
                continue
            drawn = _render_box(points, h, w)
            if drawn is None:
                continue
            mask, (y0, y1, x0, x1) = drawn
            mask &= ~to_remove[y0:y1, x0:x1]
            if score >= 0.5:
                to_remove[y0:y1, x0:x1] |= mask
            if np.count_nonzero(mask) > 100:
                mask_name = base.replace(".png", f"_{count}.png").replace(
                    ".jpg", f"_{count}.png")
                full = np.zeros((h, w), np.uint8)
                full[y0:y1, x0:x1][mask] = 255
                write_png(os.path.join(masks_dir, mask_name), full)
                lines.append(
                    f"masks/{mask_name} {meta.label_to_id[label]} "
                    f"{min(1, score * 1.2)}\n")
                count += 1
        with open(txt_path, "w") as f:
            f.writelines(lines)
