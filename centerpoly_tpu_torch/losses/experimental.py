"""Experimental raster losses (the JAX package's losses/experimental.py;
reference src/lib/models/losses.py:961-1090).

No task adds them to its total: they are diagnostics, as in the JAX
package and the reference.

  * Host half, numpy: `create_mask` (the rep-aware polygon rasterizer,
    vertices offset by a quarter canvas), `disk_loss` (disks of radius
    |r| at the predicted vertices against the rasterized GT polygon, as
    1 - IoU) and `area_poly_loss` (the predicted polygons of an image
    rasterized into one mask, MSE against a GT mask).  They rasterize
    with `geometry/pil_fill.py`, which writes Pillow's pixels, so they
    are bit-equal to the JAX package's, quirks included: the literal
    2*3.14 angle table under polar_fixed, `disk_loss` leaving out the
    last vertex's disk, and `area_poly_loss` filling one outline built
    from all K slots with each vertex cut by int().
  * Device half, PyTorch on the input's device, differentiable by
    autograd: `soft_polygon_mask` / `soft_disks_mask` (sigmoid of a
    signed distance over the whole (H, W) grid, every edge or disk at
    once: (..., H, W, N) intermediates), `disk_loss_device` and
    `area_poly_loss_device`.  The JAX package writes them as plain XLA
    ops, so they are plain torch ops here.  Ties follow JAX's gradient
    rules: `amin` and maximum / minimum split a tie evenly.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..geometry import pil_fill


def _fill_polygon(points, height: int, width: int) -> np.ndarray:
    """Pillow's polygon fill (value 255 inside, outline 255), as float32;
    nothing is drawn for fewer than 3 points."""
    img = np.zeros((height, width), np.uint8)
    pts = [(float(x), float(y)) for x, y in points]
    if len(pts) >= 3:
        pil_fill.polygon(img, pts, fill=255, outline=255)
    return img.astype(np.float32)


def create_mask(pred_row: np.ndarray, target_row: np.ndarray,
                height: int, width: int,
                rep: str = "cartesian") -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize one object's predicted + GT polygons (ref :225-277).

    pred_row/target_row: (2N,) vertex arrays in the head's representation.
    The quarter-canvas offset keeps centered polygons inside the canvas.
    """
    off_x = width // 4
    off_y = height // 4
    n2 = len(pred_row) - (len(pred_row) % 2)

    def polar(row, j):
        return (row[j] * math.cos(row[j + 1]),
                row[j] * math.sin(row[j + 1]))

    pred_pts, gt_pts = [], []
    for j in range(0, n2 - 1, 2):
        if rep == "polar":
            px, py = polar(pred_row, j)
            gx, gy = polar(target_row, j)
        elif rep == "polar_fixed":
            # prediction uses the fixed angle table; GT stays polar
            # (ref :261-272, incl. the literal 2*3.14)
            ang = 2 * 3.14 - 2 * 3.14 / n2 * j
            px = pred_row[j] * math.cos(ang)
            py = pred_row[j] * math.sin(ang)
            gx, gy = polar(target_row, j)
        else:
            px, py = pred_row[j], pred_row[j + 1]
            gx, gy = target_row[j], target_row[j + 1]
        pred_pts.append((px + off_x, py + off_y))
        gt_pts.append((gx + off_x, gy + off_y))
    return (_fill_polygon(pred_pts, height, width),
            _fill_polygon(gt_pts, height, width))


def disk_loss(pred: np.ndarray, mask: np.ndarray, target: np.ndarray,
              height: int, width: int, rep: str = "cartesian"
              ) -> Tuple[float, float]:
    """Disk-vs-GT-polygon IoU loss (ref :961-1066).

    pred/target: (B, K, 2N+1) gathered rows, the last channel the disk
    radius.  Returns (loss, repulsion); the repulsion term stays 0, as in
    the reference.  The vertex loop stops at `shape[2] - 3`, as the
    reference's does (losses.py:1013): the last vertex's disk is never
    drawn.
    """
    off_x = width // 4
    off_y = height // 4
    loss = 0.0
    for b in range(pred.shape[0]):
        for i in range(pred.shape[1]):
            if not mask[b][i]:
                continue
            _, gt_mask = create_mask(pred[b][i], target[b][i],
                                     height, width, rep)
            disks = np.zeros((height, width), np.uint8)
            r = math.ceil(abs(float(pred[b][i][-1])))
            for j in range(0, pred.shape[2] - 3, 2):
                x = float(pred[b][i][j])
                y = float(pred[b][i][j + 1])
                pil_fill.ellipse(disks, [(x - r + off_x, y - r + off_y),
                                         (x + r + off_x, y + r + off_y)],
                                 fill=255, outline=255)
            d = disks.astype(np.float32)
            inter = float(np.sum((d + gt_mask) == 510))
            union = float(np.sum(d != 0) + np.sum(gt_mask != 0) - inter)
            loss += 1 - inter / (union + 1e-6)
    denom = float(mask.sum()) + 1e-6
    return loss / denom, 0.0


def area_poly_loss(pred: np.ndarray, mask: np.ndarray,
                   target_mask: np.ndarray, centers: np.ndarray) -> float:
    """Rasterized-polygons-vs-GT-mask MSE (ref :1068-1090).

    pred: (B, K, 2N) gathered vertex rows; centers: (B, K, 2);
    target_mask: (B, H, W) GT float masks.  As in the reference
    (losses.py:1075-1089), the vertices of all K slots, padded ones too,
    make ONE outline filled by one polygon call, and `mask` enters only
    the denominator.
    """
    b, _, _ = pred.shape
    h, w = target_mask.shape[1:3]
    loss = 0.0
    for bi in range(b):
        pts = []
        for i in range(pred.shape[1]):
            for j in range(0, pred.shape[2] - 1, 2):
                pts.append((int(pred[bi][i][j] + centers[bi][i][0]),
                            int(pred[bi][i][j + 1] + centers[bi][i][1])))
        m = _fill_polygon(pts, h, w)
        loss += float(np.mean((m - target_mask[bi]) ** 2))
    denom = float(mask.sum()) * pred.shape[2] + 1e-4
    return loss / denom


def _rep_to_xy(rows: torch.Tensor, rep: str) -> torch.Tensor:
    """(..., 2N) head-representation rows -> (..., N, 2) cartesian
    vertices, create_mask's decode per rep; polar_fixed takes the literal
    2*3.14 angle table with the radii at the even channels."""
    n2 = rows.shape[-1] - (rows.shape[-1] % 2)
    rows = rows[..., :n2]
    ev = rows[..., 0::2]
    od = rows[..., 1::2]
    if rep == "polar":
        x = ev * torch.cos(od)
        y = ev * torch.sin(od)
    elif rep == "polar_fixed":
        j = torch.arange(n2 // 2, dtype=rows.dtype, device=rows.device) * 2
        ang = 2 * 3.14 - 2 * 3.14 / n2 * j
        x = ev * torch.cos(ang)
        y = ev * torch.sin(ang)
    else:
        x, y = ev, od
    return torch.stack([x, y], dim=-1)


def _grid(height: int, width: int, like: torch.Tensor):
    """Pixel centres: px (1, W, 1) and py (H, 1, 1)."""
    kw = dict(dtype=like.dtype, device=like.device)
    ys = torch.arange(height, **kw) + 0.5
    xs = torch.arange(width, **kw) + 0.5
    return xs[None, :, None], ys[:, None, None]


def soft_polygon_mask(vertices: torch.Tensor, height: int, width: int,
                      tau: float = 1.0) -> torch.Tensor:
    """Differentiable polygon rasterization: sigmoid(signed_dist / tau).

    vertices: (..., N, 2) xy in canvas coordinates.  Returns (..., H, W)
    in [0, 1] (~1 inside): inside-ness by the even-odd crossing number,
    magnitude the least distance to the polygon's edges.
    """
    px, py = _grid(height, width, vertices)
    a = vertices[..., None, None, :, :]                    # (..., 1, 1, N, 2)
    b = torch.roll(vertices, -1, dims=-2)[..., None, None, :, :]
    ax, ay, bx, by = a[..., 0], a[..., 1], b[..., 0], b[..., 1]

    # point-to-segment distance, all edges at once: (..., H, W, N)
    ex, ey = bx - ax, by - ay
    len2 = ex * ex + ey * ey + 1e-12
    t = ((px - ax) * ex + (py - ay) * ey) / len2
    t = torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))
    dx = px - (ax + t * ex)
    dy = py - (ay + t * ey)
    dist = torch.sqrt(torch.amin(dx * dx + dy * dy, dim=-1) + 1e-12)

    # even-odd crossing number (horizontal ray to +x)
    with torch.no_grad():
        cond = (ay > py) != (by > py)
        ey_safe = torch.where(ey.abs() < 1e-12, torch.full_like(ey, 1e-12),
                              ey)
        x_int = ax + (py - ay) * ex / ey_safe
        crossings = torch.sum(cond & (px < x_int), dim=-1)
        inside = crossings % 2 > 0
    signed = torch.where(inside, dist, -dist)
    return torch.sigmoid(signed / tau)


def soft_disks_mask(centers: torch.Tensor, radius: torch.Tensor,
                    height: int, width: int,
                    tau: float = 1.0) -> torch.Tensor:
    """Differentiable union-of-disks rasterization.

    centers: (..., N, 2) xy; radius: (...) or a scalar.  The union is the
    max over disks (the subgradient goes to the nearest disk)."""
    px, py = _grid(height, width, centers)
    c = centers[..., None, None, :, :]
    dx = px - c[..., 0]
    dy = py - c[..., 1]
    d = torch.sqrt(dx * dx + dy * dy + 1e-12)               # (..., H, W, N)
    radius = torch.as_tensor(radius, dtype=centers.dtype,
                             device=centers.device)
    signed = radius[..., None, None] - torch.amin(d, dim=-1)
    return torch.sigmoid(signed / tau)


def _soft_iou(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Soft IoU over the last two (H, W) axes."""
    inter = torch.sum(m1 * m2, dim=(-2, -1))
    union = torch.sum(m1 + m2 - m1 * m2, dim=(-2, -1))
    return inter / (union + 1e-6)


def disk_loss_device(pred: torch.Tensor, mask: torch.Tensor,
                     target: torch.Tensor, height: int, width: int,
                     rep: str = "cartesian", tau: float = 1.0
                     ) -> torch.Tensor:
    """Differentiable DiskLoss (the successor of disk_loss).

    pred/target: (B, K, 2N+1) gathered rows (last channel = disk radius);
    mask: (B, K).  Every one of the N disks is drawn (the host version's
    last-vertex skip is the reference's bug), and the loss is the masked
    mean of 1 - soft IoU.  Under polar_fixed only the prediction takes
    the fixed angle table; GT rows decode as polar.
    """
    gt_rep = "polar" if rep == "polar_fixed" else rep
    pv = _rep_to_xy(pred[..., :-1], "cartesian")   # disks at the raw
    gv = _rep_to_xy(target[..., :-1], gt_rep)      # channel pairs
    off = torch.tensor([width // 4, height // 4], dtype=pred.dtype,
                       device=pred.device)
    disks = soft_disks_mask(pv + off, torch.abs(pred[..., -1]),
                            height, width, tau)
    gt = soft_polygon_mask(gv + off, height, width, tau)
    per_obj = 1.0 - _soft_iou(disks, gt)                   # (B, K)
    m = mask.to(per_obj.dtype)
    return torch.sum(per_obj * m) / (torch.sum(m) + 1e-6)


def area_poly_loss_device(pred: torch.Tensor, mask: torch.Tensor,
                          target_mask: torch.Tensor, centers: torch.Tensor,
                          rep: str = "cartesian", tau: float = 1.0
                          ) -> torch.Tensor:
    """Differentiable AreaPolyLoss (the successor of area_poly_loss).

    pred: (B, K, 2N) vertex rows; centers: (B, K, 2); target_mask:
    (B, H, W) in [0, 1]; mask: (B, K).  The masked soft union of the
    objects' polygons (what the reference's one-outline fill
    approximates), MSE against the GT mask, summed over images, over
    mask.sum() + 1e-4.
    """
    h, w = target_mask.shape[1:3]
    v = _rep_to_xy(pred, rep) + centers[..., None, :]      # (B, K, N, 2)
    masks = soft_polygon_mask(v, h, w, tau)                # (B, K, H, W)
    m = mask.to(masks.dtype)[..., None, None]
    union = 1.0 - torch.prod(1.0 - masks * m, dim=1)       # (B, H, W)
    per_img = torch.mean((union - target_mask.to(union.dtype)) ** 2,
                         dim=(1, 2))
    return torch.sum(per_img) / (torch.sum(mask) + 1e-4)
