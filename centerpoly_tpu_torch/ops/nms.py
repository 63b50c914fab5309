"""Soft-NMS for multi-scale test-time merging (host numpy; behavior of the
reference's Cython extension src/lib/external/nms.pyx, used by
detectors/polydet.py:62-67 under multi-scale testing or --nms, and by the
exdet and multi_pose detectors), and the JAX package's fixed-shape
on-device variants `soft_nms_batch` and `hard_nms_batch` (ops/nms.py:73-141
there), in PyTorch on the tensor's own device.  No detector calls the
device variants; they are library functions, as in the JAX package."""
from __future__ import annotations

import numpy as np
import torch


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


def _iou_matrix(b: torch.Tensor) -> torch.Tensor:
    """(K, 4) boxes -> (K, K) IoU, the union floored at 1e-9."""
    x1 = torch.maximum(b[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(b[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(b[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = (torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0))
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp_min(area[:, None] + area[None, :] - inter,
                                   1e-9)


def soft_nms_batch(boxes: torch.Tensor, scores: torch.Tensor,
                   sigma: float = 0.5, thresh: float = 0.001) -> torch.Tensor:
    """Fixed-shape gaussian soft-NMS on the device: boxes (K, 4), scores
    (K,) -> the decayed scores (K,), 0 below `thresh`.

    K steps, as the JAX package's `lax.scan`: each takes the highest
    score not yet taken (`torch.argmax`: the first on a tie, as
    `jnp.argmax`) and multiplies every other untaken score by
    exp(-IoU^2 / sigma).  The index stays on the device, so the loop
    never waits for it."""
    k = scores.shape[0]
    ious = _iou_matrix(boxes)
    s = scores.clone()
    taken = torch.zeros(k, dtype=torch.bool, device=scores.device)
    for _ in range(k):
        i = torch.argmax(torch.where(taken, float("-inf"), s)).view(1)
        decay = torch.where(taken, 1.0, torch.exp(-(ious[i[0]] ** 2) / sigma))
        s = s * decay.index_fill(0, i, 1.0)
        taken.index_fill_(0, i, True)
    return torch.where(s >= thresh, s, 0.0)


def hard_nms_batch(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_thresh: float = 0.7) -> torch.Tensor:
    """Fixed-shape hard box-NMS on the device: the keep mask (K,) bool in
    the input order.  Over the boxes sorted by score (stable, as
    `jnp.argsort`), a box survives where no earlier surviving box
    overlaps it by more than `iou_thresh` (the reference's CUDA bitmask
    kernel's rule, src/tools/voc_eval_lib/nms/nms_kernel.cu)."""
    k = scores.shape[0]
    order = torch.argsort(-scores, stable=True)
    ious = _iou_matrix(boxes[order])
    keep = torch.ones(k, dtype=torch.bool, device=scores.device)
    for i in range(1, k):
        keep[i] = ~(keep[:i] & (ious[i, :i] > iou_thresh)).any()
    out = torch.zeros_like(keep)
    out[order] = keep
    return out
