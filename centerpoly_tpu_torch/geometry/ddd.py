"""3D box geometry of the ddd task: the port's copy of the JAX package's
geometry/ddd.py (reference src/lib/utils/ddd_utils.py and
post_process.py:15-22): the multi-bin rotation head to the observation
angle, camera unprojection, alpha to rotation_y, and the 3D box corners
and their projection.  Host-side numpy (post-process and drawing).
"""
from __future__ import annotations

import numpy as np

# KITTI's camera intrinsics (3, 4), the default calibration of ddd's 3D
# lifting (ref detectors/ddd.py:26-29)
DEFAULT_CALIB = np.array(
    [[707.0493, 0, 604.0814, 45.75831],
     [0, 707.0493, 180.5066, -0.3454157],
     [0, 0, 1.0, 0.004981016]], dtype=np.float32)


def get_alpha(rot: np.ndarray) -> np.ndarray:
    """Multi-bin rotation head (N, 8) -> observation angle alpha (N,)
    (ref post_process.py:15-22).  With arctan2, as the JAX package: the
    reference's arctan(sin / cos) loses the quadrant (alpha off by pi
    where cos < 0) and divides by zero at cos == 0."""
    idx = rot[:, 1] > rot[:, 5]
    alpha1 = np.arctan2(rot[:, 2], rot[:, 3]) + (-0.5 * np.pi)
    alpha2 = np.arctan2(rot[:, 6], rot[:, 7]) + (0.5 * np.pi)
    return alpha1 * idx + alpha2 * (1 - idx)


def unproject_2d_to_3d(pt_2d, depth: float, calib: np.ndarray) -> np.ndarray:
    """Pixel + depth -> camera coordinates (ref ddd_utils.py:69-78)."""
    z = depth - calib[2, 3]
    x = (pt_2d[0] * depth - calib[0, 3] - calib[0, 2] * z) / calib[0, 0]
    y = (pt_2d[1] * depth - calib[1, 3] - calib[1, 2] * z) / calib[1, 1]
    return np.array([x, y, z], dtype=np.float32)


def alpha2rot_y(alpha: float, x: float, cx: float, fx: float) -> float:
    """Observation angle -> yaw rotation_y in [-pi, pi] (ref
    ddd_utils.py:80-91)."""
    rot_y = alpha + np.arctan2(x - cx, fx)
    if rot_y > np.pi:
        rot_y -= 2 * np.pi
    if rot_y < -np.pi:
        rot_y += 2 * np.pi
    return rot_y


def ddd2locrot(center, alpha: float, dim, depth: float, calib: np.ndarray):
    """(centre px, alpha, dim (h, w, l), depth) -> (location xyz of the
    box's bottom centre, rotation_y) (ref ddd_utils.py:106-111)."""
    locations = unproject_2d_to_3d(center, depth, calib)
    locations[1] += dim[0] / 2
    rotation_y = alpha2rot_y(alpha, center[0], calib[0, 2], calib[0, 0])
    return locations, rotation_y


def compute_box_3d(dim, location, rotation_y: float) -> np.ndarray:
    """The 8 corners (8, 3) of a 3D box in camera coordinates (ref
    ddd_utils.py:8-23)."""
    c, s = np.cos(rotation_y), np.sin(rotation_y)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
    l, w, h = dim[2], dim[1], dim[0]
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [0, 0, 0, 0, -h, -h, -h, -h]
    z = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners = rot @ np.array([x, y, z], dtype=np.float32)
    return (corners + np.asarray(location, np.float32).reshape(3, 1)).T


def project_to_image(pts_3d: np.ndarray, calib: np.ndarray) -> np.ndarray:
    """(N, 3) camera coordinates -> (N, 2) pixels through the (3, 4)
    calibration (ref ddd_utils.py:25-33)."""
    homo = np.concatenate(
        [pts_3d, np.ones((pts_3d.shape[0], 1), np.float32)], axis=1)
    pts = (calib @ homo.T).T
    return pts[:, :2] / pts[:, 2:]
