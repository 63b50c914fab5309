"""Affine transforms for image preprocessing and detection post-processing.

The 2x3 matrix is solved in closed form from the reference's three point
correspondences (src/lib/utils/image.py:27-92) on the host;
`warp_axis_aligned` warps on the device as two f32 matrix products, and
`warp_affine_np` warps a rotated or sheared affine on the host in numpy
(the multi_pose sampler's rotation; no cv2).  Points are (x, y); images
are HWC at these functions.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def _get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Third point completing a right-angle triangle (ref image.py:69-71)."""
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _get_dir(src_point, rot_rad: float) -> np.ndarray:
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [src_point[0] * cs - src_point[1] * sn,
         src_point[0] * sn + src_point[1] * cs],
        dtype=np.float32,
    )


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine matrix mapping the 3 src points onto the 3 dst points
    (closed-form cv2.getAffineTransform)."""
    ones = np.ones((3, 1), dtype=np.float64)
    a = np.concatenate([src.astype(np.float64), ones], axis=1)  # (3, 3)
    m = np.linalg.solve(a, dst.astype(np.float64))              # (3, 2)
    return m.T.astype(np.float64)                               # (2, 3)


def get_affine_transform(center, scale, rot: float, output_size,
                         shift=(0.0, 0.0), inv: bool = False) -> np.ndarray:
    """Crop/resize affine (ref image.py:27-60): maps a source window of side
    `scale` centered at `center` onto the `output_size` = (w, h) canvas,
    with optional rotation (degrees)."""
    center = np.asarray(center, dtype=np.float32)
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale], dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    src_w = scale[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180.0
    src_dir = _get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], dtype=np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale * shift
    src[1, :] = center + src_dir + scale * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], dtype=np.float32) + dst_dir
    src[2, :] = _get_3rd_point(src[0, :], src[1, :])
    dst[2, :] = _get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform_points(pts, trans) -> np.ndarray:
    """Apply a 2x3 affine to an (..., 2) array of (x, y) points (f64)."""
    pts = np.asarray(pts, dtype=np.float64)
    return pts @ np.asarray(trans)[:, :2].T + np.asarray(trans)[:, 2]


def transform_preds(coords, center, scale, output_size) -> np.ndarray:
    """Map output-grid (x, y) coords back to source-image coords (ref
    image.py:19-24), one matrix product over all points; f32."""
    trans = get_affine_transform(center, scale, 0, output_size, inv=True)
    return affine_transform_points(coords, trans).astype(np.float32)


def warp_affine_np(image: np.ndarray, trans, out_hw,
                   fill: float = 0.0) -> np.ndarray:
    """Bilinear affine warp of an HWC image onto an (out_h, out_w) canvas
    for the forward 2x3 matrix `trans` (source -> output), any rotation or
    shear, constant border `fill`: the JAX package's
    geometry/affine.py::warp_affine in numpy f32 (the inverse of trans's
    2x2 part applied element by element, four clipped taps each masked
    outside the image), which is cv2.warpAffine's INTER_LINEAR without
    its 1/32-pixel fixed-point weights and uint8 rounding.  Returns
    (out_h, out_w, C) float32."""
    trans = np.asarray(trans, np.float32)
    inv_a = np.linalg.inv(trans[:, :2]).astype(np.float32)
    t = trans[:, 2]
    out_h, out_w = out_hw
    gx, gy = np.meshgrid(np.arange(out_w, dtype=np.float32),
                         np.arange(out_h, dtype=np.float32))
    dx, dy = gx - t[0], gy - t[1]
    sx = dx * inv_a[0, 0] + dy * inv_a[0, 1]
    sy = dx * inv_a[1, 0] + dy * inv_a[1, 1]
    h, w = image.shape[:2]
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    img = image.astype(np.float32)

    def sample(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(valid[..., None], v, np.float32(fill))

    one = np.float32(1)
    return (sample(y0, x0) * (one - fx) * (one - fy)
            + sample(y0, x0 + 1) * fx * (one - fy)
            + sample(y0 + 1, x0) * (one - fx) * fy
            + sample(y0 + 1, x0 + 1) * fx * fy)


def _sampling_matrix(out_size: int, in_size: int, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """(out, in) bilinear sampling matrix for in = (out - shift) / scale.
    Out-of-range taps contribute zero (constant-border fill 0, like
    cv2.warpAffine); no renormalization."""
    o = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    src = (o - shift) / scale
    i = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    return (1.0 - (src[:, None] - i[None, :]).abs()).clamp_min(0.0)


@contextlib.contextmanager
def _full_f32_matmul():
    """TF32 would round pixel values to ~3 decimal digits; the JAX package
    computes this warp at HIGHEST precision."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def warp_axis_aligned(image: torch.Tensor, trans, out_hw) -> torch.Tensor:
    """Axis-aligned (no rotation/shear) affine warp of an HWC float image:
    out = W_y @ image @ W_x^T with explicit bilinear sampling matrices,
    for trans = [[ax, 0, tx], [0, ay, ty]] (source -> output).  Returns
    (out_h, out_w, C) in the image's dtype."""
    trans = torch.as_tensor(trans, dtype=torch.float32, device=image.device)
    out_h, out_w = out_hw
    in_h, in_w, c = image.shape
    wy = _sampling_matrix(out_h, in_h, trans[1, 1], trans[1, 2])
    wx = _sampling_matrix(out_w, in_w, trans[0, 0], trans[0, 2])
    img = image.float()
    with _full_f32_matmul():
        rows = (wy @ img.reshape(in_h, in_w * c)).reshape(out_h, in_w, c)
        # contract the columns with the channels out of the way:
        # (out_h*C, in_w) @ (in_w, out_w)
        cols = rows.permute(0, 2, 1).reshape(out_h * c, in_w) @ wx.T
    return cols.reshape(out_h, c, out_w).permute(0, 2, 1).to(image.dtype)
