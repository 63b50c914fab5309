"""Gaussian target splatting for centre heatmaps, on the host.

The port's copy of the numpy half of the JAX package's
geometry/gaussian.py, which mirrors the reference GT encoder
(src/lib/utils/image.py:95-205).
"""
from __future__ import annotations

import numpy as np


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet radius so any center within it keeps IoU>=min_overlap.

    Matches reference image.py:95-115 (three quadratic cases, min).
    """
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(b1 ** 2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2 ** 2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def _gaussian2d(shape, sigma: float) -> np.ndarray:
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def splat_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0):
    """Max-merge a round gaussian patch into `heatmap` (ref image.py:126-141)."""
    diameter = 2 * radius + 1
    gaussian = _gaussian2d((diameter, diameter), sigma=diameter / 6)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    if right + left <= 0 or bottom + top <= 0:
        return heatmap
    masked_heatmap = heatmap[y - top:y + bottom, x - left:x + right]
    masked_gaussian = gaussian[radius - top:radius + bottom,
                               radius - left:radius + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


def splat_msra_gaussian(heatmap: np.ndarray, center, sigma: float):
    """Max-merge a fixed-sigma gaussian, MSRA pose style (ref
    image.py:208-228); ctdet's heat map under --mse_loss (hm_gauss)."""
    tmp_size = int(sigma * 3)
    mu_x = int(center[0] + 0.5)
    mu_y = int(center[1] + 0.5)
    h, w = heatmap.shape[:2]
    ul = [mu_x - tmp_size, mu_y - tmp_size]
    br = [mu_x + tmp_size + 1, mu_y + tmp_size + 1]
    if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0:
        return heatmap
    size = 2 * tmp_size + 1
    x = np.arange(0, size, 1, np.float32)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
    g_x = max(0, -ul[0]), min(br[0], w) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], h) - ul[1]
    img_x = max(0, ul[0]), min(br[0], w)
    img_y = max(0, ul[1]), min(br[1], h)
    heatmap[img_y[0]:img_y[1], img_x[0]:img_x[1]] = np.maximum(
        heatmap[img_y[0]:img_y[1], img_x[0]:img_x[1]],
        g[g_y[0]:g_y[1], g_x[0]:g_x[1]])
    return heatmap


def draw_dense_reg(regmap: np.ndarray, heatmap: np.ndarray, center, value,
                   radius: int, is_offset: bool = False):
    """Splat a regression value into a dense HWD map where this object's
    gaussian dominates the current heatmap max (ref image.py:176-205,
    channel-last here).

    regmap (H, W, D); heatmap (H, W) current class-max; value (D,)."""
    diameter = 2 * radius + 1
    gaussian = _gaussian2d((diameter, diameter), sigma=diameter / 6)
    value = np.array(value, np.float32).reshape(1, 1, -1)
    dim = value.shape[-1]
    reg = np.ones((diameter * 2 + 1, diameter * 2 + 1, dim),
                  np.float32) * value
    if is_offset and dim == 2:
        delta = np.arange(diameter * 2 + 1) - radius
        reg[:, :, 0] -= delta.reshape(1, -1)
        reg[:, :, 1] -= delta.reshape(-1, 1)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top:y + bottom, x - left:x + right]
    masked_regmap = regmap[y - top:y + bottom, x - left:x + right]
    masked_gaussian = gaussian[radius - top:radius + bottom,
                               radius - left:radius + right]
    masked_reg = reg[radius - top:radius + bottom,
                     radius - left:radius + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        idx = (masked_gaussian >= masked_heatmap)[..., None]
        masked_regmap = (~idx) * masked_regmap + idx * masked_reg
    regmap[y - top:y + bottom, x - left:x + right] = masked_regmap
    return regmap


def _gaussian_ellipse2d(shape, sigma: float) -> np.ndarray:
    """Elliptical gaussian patch; formula matches ref image.py:144-156.

    shape = (2*radius_y+1, 2*radius_x+1).  Note the reference scales row
    offsets by W/max and column offsets by H/max (its x/y names are swapped
    but self-consistent); reproduced as-is for target parity.
    """
    h, w = shape
    max_radius = max(h, w)
    row_scale = w / max_radius
    col_scale = h / max_radius
    rows = (np.arange(h) - h // 2) * row_scale
    cols = (np.arange(w) - w // 2) * col_scale
    val = (rows[:, None] ** 2 + cols[None, :] ** 2) / (2 * sigma ** 2)
    return np.exp(-val)


def splat_ellipse_gaussian(heatmap: np.ndarray, center, radius_x: int,
                           radius_y: int, k: float = 1.0):
    """Max-merge an elliptical gaussian (ref image.py:159-173)."""
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius_x), min(width - x, radius_x + 1)
    top, bottom = min(y, radius_y), min(height - y, radius_y + 1)
    sigma = (2 * min(radius_x, radius_y) + 1) / 6
    gaussian = _gaussian_ellipse2d((2 * radius_y + 1, 2 * radius_x + 1), sigma)
    masked_heatmap = heatmap[y - top:y + bottom, x - left:x + right]
    masked_gaussian = gaussian[radius_y - top:radius_y + bottom,
                               radius_x - left:radius_x + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap
