"""Soft-NMS for multi-scale test-time merging (host numpy; behavior of the
reference's Cython extension src/lib/external/nms.pyx, used by
detectors/polydet.py:62-67 under multi-scale testing or --nms, and by the
exdet and multi_pose detectors)."""
from __future__ import annotations

import numpy as np


def _iou_single(box, boxes):
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    iw = np.maximum(x2 - x1, 0.0)
    ih = np.maximum(y2 - y1, 0.0)
    inter = iw * ih
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-9)


def soft_nms(dets: np.ndarray, nt: float = 0.5, sigma: float = 0.5,
             thresh: float = 0.001, method: int = 2) -> np.ndarray:
    """In-place soft-NMS over rows [x0, y0, x1, y1, score, ...].

    method: 0 = hard NMS, 1 = linear, 2 = gaussian.  Returns indices kept
    (scores in `dets` are updated in place, the Cython extension's
    contract).
    """
    n = dets.shape[0]
    keep = []
    boxes = dets[:, :4]
    scores = dets[:, 4]
    alive = np.ones(n, dtype=bool)
    while True:
        live = np.where(alive)[0]
        if live.size == 0:
            break
        i = live[np.argmax(scores[live])]
        if scores[i] < thresh:
            break
        keep.append(i)
        alive[i] = False
        rest = np.where(alive)[0]
        if rest.size == 0:
            break
        ious = _iou_single(boxes[i], boxes[rest])
        if method == 1:  # linear
            decay = np.where(ious > nt, 1.0 - ious, 1.0)
        elif method == 2:  # gaussian
            decay = np.exp(-(ious * ious) / sigma)
        else:  # hard
            decay = np.where(ious > nt, 0.0, 1.0)
        scores[rest] *= decay
        alive[rest] &= scores[rest] >= thresh
    return np.array(keep, dtype=np.int64)


def soft_nms_39(dets: np.ndarray, nt: float = 0.5, sigma: float = 0.5,
                thresh: float = 0.001, method: int = 2) -> np.ndarray:
    """The 39-column (pose) variant (ref nms.pyx soft_nms_39): the routine
    reads only columns :4 and updates column 4, so it is `soft_nms`."""
    return soft_nms(dets, nt=nt, sigma=sigma, thresh=thresh, method=method)
