"""Pillow's `ImageDraw.polygon` and `ImageDraw.ellipse` in numpy.

The JAX package rasterizes its experimental losses and its GT tools with
Pillow; the card's machine has no Pillow.  These two functions write
exactly the pixels Pillow 12 writes for the same call on an "L" image,
with `width=1`:

  * every coordinate is truncated toward zero first (Pillow casts each
    double to int before it draws);
  * the polygon fill is Pillow's scanline rule: on each integer row, the
    x of every non-horizontal edge that spans the row, in float32, an
    edge's lower end entered twice (except on the last row), sorted,
    paired, and each pair drawn from its left x rounded half away from
    zero to its right x rounded half toward zero; horizontal edges are
    drawn whole.  Where two non-vertical edges start (or end) together on
    a row at the same rounded x, the later one's x is moved one pixel
    past the nearer of the two edges' x on the next (previous) row, if
    both lie more than a pixel to one side: Pillow's "discontiguous
    corner" rule;
  * the outline is Pillow's Bresenham line from each vertex to the next,
    the end point left out, drawn after the fill: `outline=0` erases the
    polygon's border;
  * the ellipse is Pillow's integer ellipse (quarter arcs on a doubled
    grid, the filled one as the outline of width a + b).

`tests/test_torch_experimental_losses.py` holds both to Pillow pixel for
pixel.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

_F32 = np.float32
_HALF = np.float32(0.5)


def _trunc_points(points) -> List[Tuple[int, int]]:
    """Vertices as C's (int) cast of a double makes them."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    if len(pts) < 2:
        raise TypeError("coordinate list must contain at least 2 "
                        "coordinates")
    return [(int(x), int(y)) for x, y in np.trunc(pts).tolist()]


def _c_round(v: float) -> float:
    """C's roundf: half away from zero."""
    return math.copysign(math.floor(abs(v) + 0.5), v)


def _round_up(f: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP (half away from zero, the +0.5 in float32)."""
    return np.copysign(np.floor(np.abs(f) + _HALF), f).astype(np.int64)


def _round_down(f: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_DOWN (half toward zero, the -0.5 in float32)."""
    return np.copysign(np.ceil(np.abs(f) - _HALF), f).astype(np.int64)


def _edges(xy: List[Tuple[int, int]]) -> np.ndarray:
    """Pillow's edge list (ImagingDrawPolygon): one row (xmin, xmax, ymin,
    ymax, x0, y0, x1 - x0, y1 - y0) an edge; a horizontal edge that
    continues a horizontal edge in the same x direction extends it, and
    the closing edge is left out where the last vertex is the first."""
    rows: List[List[int]] = []
    n = len(xy)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            px = xy[i - 1][0]
            if x1 > x0 > px:
                rows[-1][1] = x1
                continue
            if x1 < x0 < px:
                rows[-1][0] = x1
                continue
        rows.append([min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1),
                     x0, y0, x1 - x0, y1 - y0])
    if xy[-1] != xy[0]:
        (x0, y0), (x1, y1) = xy[-1], xy[0]
        rows.append([min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1),
                     x0, y0, x1 - x0, y1 - y0])
    return np.asarray(rows, np.int64).reshape(-1, 8)


def _paint(canvas: np.ndarray, rows, x0, x1, ink) -> None:
    """canvas[rows, x0..x1] = ink (inclusive spans), clipped as Pillow's
    hline clips, over the spans' bounding box only."""
    rows, x0, x1 = (np.concatenate(v) for v in (rows, x0, x1))
    h, w = canvas.shape[:2]
    s = np.maximum(x0, 0)
    e = np.minimum(x1, w - 1)
    keep = (rows >= 0) & (rows < h) & (s <= e)
    if not keep.any():
        return
    rows, s, e = rows[keep], s[keep], e[keep]
    r0, c0 = int(rows.min()), int(s.min())
    nr, nc = int(rows.max()) - r0 + 1, int(e.max()) - c0 + 1
    diff = np.zeros((nr, nc + 1), np.int32)
    np.add.at(diff, (rows - r0, s - c0), 1)
    np.add.at(diff, (rows - r0, e - c0 + 1), -1)
    band = canvas[r0:r0 + nr, c0:c0 + nc]
    band[np.cumsum(diff[:, :nc], axis=1) > 0] = ink


def _fill(canvas: np.ndarray, xy: List[Tuple[int, int]], ink) -> None:
    """Pillow's polygon fill (polygon_generic)."""
    h = canvas.shape[0]
    e = _edges(xy)
    if len(e) == 0:
        return
    xmin, xmax, ymin, ymax, ex0, ey0, ddx, ddy = e.T
    horiz = ymin == ymax
    spans = ([ymin[horiz]], [xmin[horiz]], [xmax[horiz]])
    y_lo = max(min(h - 1, int(ymin.min())), 0)
    y_hi = min(max(0, int(ymax.max())), h)
    t = ~horiz
    if not t.any() or y_lo > min(y_hi, h - 1):
        _paint(canvas, *spans, ink)
        return
    tymin, tymax, tx0, ty0 = ymin[t], ymax[t], ex0[t], ey0[t]
    tdx = ddx[t].astype(_F32) / ddy[t].astype(_F32)

    def x_at(y, k):
        return _F32(y - int(ty0[k])) * tdx[k] + _F32(int(tx0[k]))

    ys = np.arange(y_lo, min(y_hi, h - 1) + 1, dtype=np.int64)
    yc = ys[:, None]
    x = (yc - ty0).astype(_F32) * tdx + tx0.astype(_F32)
    act = (yc >= tymin) & (yc <= tymax)
    dup = act & (yc == tymax) & (yc < y_hi)
    # discontiguous corners: a non-vertical edge starting (ending) on a
    # row, against the earlier non-vertical edges starting (ending) there
    cand = act & ~dup & (tdx != 0) & ((yc == tymin) | (yc == tymax))
    starts: Dict[int, List[int]] = {}
    ends: Dict[int, List[int]] = {}
    for k in np.nonzero(tdx != 0)[0].tolist():
        starts.setdefault(int(tymin[k]), []).append(k)
        ends.setdefault(int(tymax[k]), []).append(k)
    x_edge = x.copy()       # the edges' own x, before any corner moves
    for r, i in zip(*np.nonzero(cand)):
        y = int(ys[r])
        at_end = y == int(tymax[i])
        xi = x[r, i]
        for k in (ends if at_end else starts).get(y, ()):
            if k >= i:
                break
            if _c_round(float(xi)) != _c_round(float(x_edge[r, k])):
                continue
            off = -1 if at_end else 1
            a, b = x_at(y + off, i), x_at(y + off, k)
            if xi > a + 1 and xi > b + 1:
                x[r, i] = _F32(_c_round(float(max(a, b))) + 1)
            elif xi < a - 1 and xi < b - 1:
                x[r, i] = _F32(_c_round(float(min(a, b))) - 1)
            break
    inf = _F32(np.inf)
    v = np.sort(np.concatenate([np.where(act, x, inf),
                                np.where(dup, x, inf)], axis=1), axis=1)
    count = act.sum(1) + dup.sum(1)
    left, right = v[:, 0::2], v[:, 1::2]
    pair = 2 * np.arange(right.shape[1]) + 1 < count[:, None]
    r, p = np.nonzero(pair)
    spans[0].append(ys[r])
    spans[1].append(_round_up(left[r, p]))
    spans[2].append(_round_down(right[r, p]))
    _paint(canvas, *spans, ink)


def _line_points(x0: int, y0: int, x1: int, y1: int, h: int, w: int):
    """Pillow's line8 (Bresenham; the end point left out) as (xs, ys),
    only the steps whose major coordinate lies on the canvas."""
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    xs_, ys_ = (1 if x1 >= x0 else -1), (1 if y1 >= y0 else -1)
    x_major = dx > dy
    n, minor = (dx, dy) if x_major else (dy, dx)
    start, s, size = (x0, xs_, w) if x_major else (y0, ys_, h)
    lo, hi = (-start, size - 1 - start) if s > 0 else \
        (start - (size - 1), start)
    i = np.arange(max(lo, 0), min(hi, n - 1) + 1, dtype=np.int64)
    step = (2 * minor * i + n) // (2 * n) if minor else np.zeros_like(i)
    if x_major:
        return x0 + xs_ * i, y0 + ys_ * step
    return x0 + xs_ * step, y0 + ys_ * i


def _outline(canvas: np.ndarray, xy: List[Tuple[int, int]], ink) -> None:
    h, w = canvas.shape[:2]
    n = len(xy)
    for i in range(n):
        (x0, y0), (x1, y1) = xy[i], xy[(i + 1) % n]
        xs, ys = _line_points(x0, y0, x1, y1, h, w)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        canvas[ys[keep], xs[keep]] = ink


def polygon(canvas: np.ndarray, points: Sequence, fill=None,
            outline=None) -> np.ndarray:
    """`ImageDraw.Draw(img).polygon(points, fill=fill, outline=outline)`
    on `canvas` (H, W), in place; returns it.  None leaves a part out; an
    outline equal to the fill is not drawn, as in Pillow."""
    xy = _trunc_points(points)
    if fill is not None:
        _fill(canvas, xy, fill)
    if outline is not None and outline != fill:
        _outline(canvas, xy, outline)
    return canvas


class _Quarter:
    """Pillow's quarter_state: one quarter of the ellipse of semi-axes
    a/2, b/2 on the doubled grid, point by point."""

    def __init__(self, a: int, b: int):
        self.finished = a < 0 or b < 0
        if not self.finished:
            self.cx, self.cy, self.ex, self.ey = a, b % 2, a % 2, b
            self.a2, self.b2 = a * a, b * b
            self.a2b2 = self.a2 * self.b2

    def _delta(self, x: int, y: int) -> int:
        return abs(self.a2 * y * y + self.b2 * x * x - self.a2b2)

    def next(self):
        if self.finished:
            return None
        ret = (self.cx, self.cy)
        if self.cx == self.ex and self.cy == self.ey:
            self.finished = True
            return ret
        nx, ny = self.cx, self.cy + 2
        nd = self._delta(nx, ny)
        if nx > 1:
            d = self._delta(self.cx - 2, self.cy + 2)
            if nd > d:
                nx, ny, nd = self.cx - 2, self.cy + 2, d
            d = self._delta(self.cx - 2, self.cy)
            if nd > d:
                nx, ny = self.cx - 2, self.cy
        self.cx, self.cy = nx, ny
        return ret


def _ellipse_spans(a: int, b: int, width: int):
    """Pillow's ellipse_state: (x0, y, x1) spans on the doubled grid, the
    outline of `width` between the outer and the inner quarter."""
    leftmost = a % 2
    outer = _Quarter(a, b)
    first = outer.next()
    if width < 1 or first is None:
        return
    pr, py = first
    inner = _Quarter(a - 2 * (width - 1), b - 2 * (width - 1))
    pl = leftmost
    finished = False
    while not finished:
        y, l, r = py, pl, pr
        nxt = outer.next()
        while nxt is not None and nxt[1] <= y:
            nxt = outer.next()
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        nxt = inner.next()
        while nxt is not None and nxt[1] <= y:
            l = nxt[0]
            nxt = inner.next()
        pl = leftmost if nxt is None else nxt[0]
        buf = []
        if (l > 0 or l < r) and y > 0:
            buf.append((2 if l == 0 else l, y, r))
        if y > 0:
            buf.append((-r, y, -l))
        if l > 0 or l < r:
            buf.append((2 if l == 0 else l, -y, r))
        buf.append((-r, -y, -l))
        yield from reversed(buf)


def _draw_ellipse(canvas, x0, y0, x1, y1, ink, width) -> None:
    a, b = x1 - x0, y1 - y0
    if a < 0 or b < 0:
        return
    spans = np.asarray(list(_ellipse_spans(a, b, width)),
                       np.int64).reshape(-1, 3)
    _paint(canvas, [y0 + (spans[:, 1] + b) // 2],
           [x0 + (spans[:, 0] + a) // 2], [x0 + (spans[:, 2] + a) // 2], ink)


def ellipse(canvas: np.ndarray, box: Sequence, fill=None,
            outline=None, width: int = 1) -> np.ndarray:
    """`ImageDraw.Draw(img).ellipse(box, fill=fill, outline=outline,
    width=width)` on `canvas` (H, W), in place; returns it.  `box` is
    [(x0, y0), (x1, y1)] or [x0, y0, x1, y1]."""
    x0, y0, x1, y1 = np.asarray(box, np.float64).reshape(4).tolist()
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    if fill is not None:
        _draw_ellipse(canvas, x0, y0, x1, y1, fill, (x1 - x0) + (y1 - y0))
    if outline is not None and outline != fill and width != 0:
        _draw_ellipse(canvas, x0, y0, x1, y1, outline, width)
    return canvas
