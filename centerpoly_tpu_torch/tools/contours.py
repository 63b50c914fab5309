"""Three cv2 contour functions in numpy, for tools/analysis.py's
`simplify_masks` (the card's machine has no cv2):

  * `find_external_contours(mask)`: cv2.findContours(mask,
    RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)'s list of contours.  Suzuki and
    Abe's border following, as OpenCV's contours.cpp does it: the mask
    binarized and framed by a 1-pixel zero border, scanned in raster
    order; an outer border starts at a 1 whose left neighbour is 0, and is
    skipped where the last marked border pixel to its left on the row is
    a left border (it lies inside another component's hole); each border
    is followed with the 8-neighbour search, its pixels marked (2, or
    -126 where the right neighbour is background), and a point kept where
    the chain code changes.  The list is returned last-found first, as
    cv2 returns it.
  * `arc_length(points, closed)`: cv2.arcLength, each segment's length in
    float32, summed in double.
  * `approx_poly_dp(points, eps)`: cv2.approxPolyDP(closed=True), OpenCV's
    approx.cpp Douglas-Peucker: the curve is first cut at two far-apart
    points (three farthest-point hops from vertex 0); a slice is split at
    its point farthest from its chord, the distance to the chord's
    segment (not its line), while that distance exceeds eps; a last pass
    drops points within sqrt(eps^2 / 2) of the line through their
    neighbours that lie between them.

`tests/test_torch_host_tools.py` holds each to cv2's vertex lists.
"""
from __future__ import annotations

from typing import List

import numpy as np

# chain code k: (dx, dy), counter-clockwise from +x with y down
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)


def _follow(img: np.ndarray, x0: int, y0: int) -> List[List[int]]:
    """icvFetchContour for an outer border starting at padded (x0, y0):
    marks the border in `img` and returns its CHAIN_APPROX_SIMPLE points
    in unpadded coordinates."""
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        x1, y1 = x0 + _DX[s], y0 + _DY[s]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:                      # a single pixel
        img[y0, x0] = -126
        return [[x0 - 1, y0 - 1]]
    pts = []
    x3, y3 = x0, y0
    px, py = x0 - 1, y0 - 1
    prev_s = s ^ 4
    while True:
        s_end = s
        while True:
            s += 1
            x4, y4 = x3 + _DX[s & 7], y3 + _DY[s & 7]
            if img[y4, x4] != 0 or s >= 15:
                break
        s &= 7
        if 1 <= s <= s_end:             # the right neighbour is background
            img[y3, x3] = -126
        elif img[y3, x3] == 1:
            img[y3, x3] = 2
        if s != prev_s:
            pts.append([px, py])
            prev_s = s
        px += _DX[s]
        py += _DY[s]
        if x4 == x0 and y4 == y0 and x3 == x1 and y3 == y1:
            return pts
        x3, y3 = x4, y4
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]:
    a list of (n, 1, 2) int32 point arrays, last-found first."""
    h, w = mask.shape[:2]
    img = np.zeros((h + 2, w + 2), np.int16)
    img[1:-1, 1:-1] = mask != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        if not row.any():
            continue
        x, prev, lnbd = 1, 0, 0
        while x < w + 2:
            # the next pixel whose value differs from prev
            rest = np.nonzero(row[x:] != prev)[0]
            if len(rest) == 0:
                break
            x += int(rest[0])
            p = int(row[x])
            if prev == 0 and p == 1 and row[lnbd] <= 0:
                found.append(_follow(img, x, y))
                prev = int(row[x])
                x += 1
                continue
            prev = p
            if prev & -2:
                lnbd = x
            x += 1
    return [np.asarray(c, np.int32).reshape(-1, 1, 2) for c in found[::-1]]


def arc_length(points, closed: bool = True) -> float:
    """cv2.arcLength(points, closed)."""
    p = np.asarray(points).reshape(-1, 2).astype(np.float32)
    if len(p) <= 1:
        return 0.0
    prev = np.concatenate([p[-1:] if closed else p[:1], p[:-1]])
    d = p - prev
    seg = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    total = 0.0
    for v in seg.tolist():
        total += v
    return total


def _seg_dist2(pt, a, b, dx: float, dy: float, len2: float) -> float:
    """Squared distance from pt to the segment a-b (dx, dy = b - a)."""
    ex, ey = pt[0] - a[0], pt[1] - a[1]
    dot = ex * dx + ey * dy
    if dot <= 0:
        return float(ex * ex + ey * ey)
    if dot >= len2:
        fx, fy = pt[0] - b[0], pt[1] - b[1]
        return float(fx * fx + fy * fy)
    cross = ey * dx - ex * dy
    return cross * cross / len2


def approx_poly_dp(points, epsilon: float) -> np.ndarray:
    """cv2.approxPolyDP(points, epsilon, closed=True) for integer points:
    (m, 1, 2) int32."""
    src = [tuple(p) for p in np.asarray(points).reshape(-1, 2).tolist()]
    count = len(src)
    if count == 0:
        return np.zeros((0, 1, 2), np.int32)
    eps = epsilon * epsilon
    dst: List[tuple] = []
    stack: List[List[int]] = []
    # two far-apart points of the curve: three farthest-point hops
    pos = right_start = 0
    le_eps = False
    for _ in range(3):
        pos = (pos + right_start) % count
        start_pt = src[pos]
        pos = (pos + 1) % count
        max_dist = 0.0
        for j in range(1, count):
            pt = src[pos]
            pos = (pos + 1) % count
            dx, dy = pt[0] - start_pt[0], pt[1] - start_pt[1]
            dist = float(dx * dx + dy * dy)
            if dist > max_dist:
                max_dist, right_start = dist, j
        le_eps = max_dist <= eps
    if le_eps:
        dst.append(start_pt)
    else:
        s_start = pos % count
        s_end = (right_start + s_start) % count
        stack.append([s_end, s_start])
        stack.append([s_start, s_end])
    # split each slice at its point farthest from its chord's segment
    while stack:
        s_start, s_end = stack.pop()
        end_pt = src[s_end]
        start_pt = src[s_start]
        pos = (s_start + 1) % count
        if pos != s_end:
            dx = float(end_pt[0] - start_pt[0])
            dy = float(end_pt[1] - start_pt[1])
            max_dist = 0.0
            split = s_start
            len2 = dx * dx + dy * dy
            while pos != s_end:
                pt = src[pos]
                pos = (pos + 1) % count
                dist = _seg_dist2(pt, start_pt, end_pt, dx, dy, len2)
                if dist > max_dist:
                    max_dist = dist
                    split = (pos + count - 1) % count
            le_eps = max_dist <= eps
        else:
            le_eps = True
        if le_eps:
            dst.append(start_pt)
        else:
            stack.append([split, s_end])
            stack.append([s_start, split])

    # drop points on [almost] straight runs, in place and circularly
    count = new_count = len(dst)
    pos = count - 1
    start_pt = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    i = 0
    while i < count and new_count > 2:
        end_pt = dst[pos]
        pos = (pos + 1) % count
        dx = float(end_pt[0] - start_pt[0])
        dy = float(end_pt[1] - start_pt[1])
        dist = abs((pt[0] - start_pt[0]) * dy - (pt[1] - start_pt[1]) * dx)
        inner = ((pt[0] - start_pt[0]) * (end_pt[0] - pt[0])
                 + (pt[1] - start_pt[1]) * (end_pt[1] - pt[1]))
        if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0
                and dy != 0 and inner >= 0):
            new_count -= 1
            dst[wpos] = start_pt = end_pt
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start_pt = pt
        wpos = (wpos + 1) % count
        pt = end_pt
        i += 1
    return np.asarray(dst[:new_count], np.int32).reshape(-1, 1, 2)
