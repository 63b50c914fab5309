"""Seeded street-like frames: dark uint8 noise (0-39) with 1-3 filled
bright rectangles, each annotated as a 16-vertex polygon along its
perimeter, clockwise from its top-left corner (the port's
data/fixture.py rectangle fixture), here each of a class drawn from the
8 Cityscapes classes and with pseudo-depth = its index in the frame.  A
task's training targets are its own (benchmark/tasks/<task>.py).

The same seed gives the same frames."""
from __future__ import annotations

import numpy as np

N_CLASSES = 8


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


def make_frames(rng: np.random.Generator, count: int, h: int, w: int,
                n_points: int = 16):
    """`count` frames (h, w, 3) uint8 and, for each, its objects as
    (polygon (n_points, 2) in frame pixels, class 0-7, pseudo-depth, box
    (x0, y0, w, h))."""
    frames, objects = [], []
    for _ in range(count):
        img = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
        objs = []
        for k in range(1 + int(rng.integers(0, 3))):
            bw = int(rng.integers(w // 8, w // 3))
            bh = int(rng.integers(h // 6, h // 2))
            x0 = int(rng.integers(2, w - bw - 3))
            y0 = int(rng.integers(2, h - bh - 3))
            img[y0:y0 + bh + 1, x0:x0 + bw + 1] = rng.integers(
                140, 256, 3, dtype=np.uint8)
            objs.append((rect_poly(x0, y0, bw, bh, n_points),
                         int(rng.integers(0, N_CLASSES)), float(k),
                         (x0, y0, bw, bh)))
        frames.append(img)
        objects.append(objs)
    return frames, objects
