"""Detectors of the multi_pose and exdet tasks: the port's copy of the
JAX package's infer/task_detectors.py (reference src/lib/detectors/
{multi_pose,exdet}.py).  Both share BaseDetector's run loop (`run`,
`run_batch`, `run_stream`); each gives its decode of the head maps on
the device and its host post-process and merge.

multi_pose rows are [x0, y0, x1, y1, score, 17 (x, y) joints] under class
1; exdet's merged rows are [x0, y0, x1, y1, score] a class.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..data.multi_pose_sampler import FLIP_IDX
from ..geometry.affine import get_affine_transform, transform_preds
from ..losses.exdet import PARTS
from ..ops.decode import exct_decode, multi_pose_decode
from ..ops.nms import soft_nms, soft_nms_39
from .detector import BaseDetector


def multi_pose_post_process(dets: np.ndarray, c, s, out_h: int, out_w: int
                            ) -> List[Dict[int, list]]:
    """Decoded multi_pose rows (B, K, 40) -> source-image coordinates,
    [bbox 4, score, 34 joint coords] rows under class 1 (ref
    post_process.py:123-135)."""
    ret = []
    for i in range(dets.shape[0]):
        bbox = transform_preds(dets[i, :, :4].reshape(-1, 2), c[i], s[i],
                               (out_w, out_h))
        pts = transform_preds(dets[i, :, 5:39].reshape(-1, 2), c[i], s[i],
                              (out_w, out_h))
        top = np.concatenate(
            [bbox.reshape(-1, 4), dets[i, :, 4:5], pts.reshape(-1, 34)],
            axis=1).astype(np.float32).tolist()
        ret.append({1: top})
    return ret


def _flip_joint_perm(num_joints: int = 17) -> np.ndarray:
    """COCO's left/right joint swap as a permutation (ref opts flip_idx)."""
    perm = np.arange(num_joints)
    for a, b in FLIP_IDX:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


class MultiPoseDetector(BaseDetector):
    """Human-pose detector (ref detectors/multi_pose.py)."""

    def _decode(self, heads):
        cfg = self.cfg
        out = {k: v.float().permute(0, 2, 3, 1)
               for k, v in heads.items()}                       # NHWC views
        hm = torch.sigmoid(out["hm"])
        wh = out["wh"]
        hps = out["hps"]
        reg = out["reg"] if cfg.reg_offset else None
        hm_hp = torch.sigmoid(out["hm_hp"]) if cfg.hm_hp else None
        hp_offset = out["hp_offset"] if cfg.reg_hp_offset else None
        if cfg.flip_test:
            # [originals(B); flipped(B)]: average the heat map and wh with
            # the mirrored half; mirror the joint offsets, negate their x
            # and swap left and right joints (ref models/utils.py:28-50
            # flip_lr / flip_lr_off); keep the unflipped offsets
            nb, h, w = hm.shape[0] // 2, hm.shape[1], hm.shape[2]
            perm = torch.as_tensor(_flip_joint_perm(hps.shape[-1] // 2),
                                   device=hps.device)
            hm = (hm[:nb] + hm[nb:].flip(2)) / 2
            wh = (wh[:nb] + wh[nb:].flip(2)) / 2
            hf = hps[nb:].flip(2).reshape(nb, h, w, -1, 2)
            hf = hf * hf.new_tensor([-1.0, 1.0])
            hf = hf[:, :, :, perm, :].reshape(nb, h, w, -1)
            hps = (hps[:nb] + hf) / 2
            if hm_hp is not None:
                hm_hp = (hm_hp[:nb] + hm_hp[nb:].flip(2)[..., perm]) / 2
            reg = reg[:nb] if reg is not None else None
            hp_offset = hp_offset[:nb] if hp_offset is not None else None
        return multi_pose_decode(hm, wh, hps, reg=reg, hm_hp=hm_hp,
                                 hp_offset=hp_offset, k=cfg.K)

    def _post(self, dets_host, meta, scale):
        pp = multi_pose_post_process(
            dets_host[:1], [meta["c"]], [meta["s"]],
            meta["out_height"], meta["out_width"])[0]
        pp[1] = np.array(pp[1], np.float32).reshape(-1, 39)
        pp[1][:, :4] /= scale
        pp[1][:, 5:] /= scale
        return pp

    def merge_outputs(self, detections):
        """Concat scales; soft-NMS under --nms or several scales (ref
        detectors/multi_pose.py:76-83); no top-K cut."""
        results = {1: np.concatenate([d[1] for d in detections],
                                     axis=0).astype(np.float32)}
        if self.cfg.nms or len(self.scales) > 1:
            soft_nms_39(results[1], nt=0.5, method=2)
        return results


class ExdetDetector(BaseDetector):
    """ExtremeNet detector (ref detectors/exdet.py).  flip_tta is off: the
    reference doubles the batch under flip_test but its post-process reads
    only the unflipped rows, so a batch of B gives the same results."""

    flip_tta = False

    def _decode(self, heads):
        cfg = self.cfg
        out = {k: v.float().permute(0, 2, 3, 1)
               for k, v in heads.items()}                       # NHWC views
        heats = {p: torch.sigmoid(out[f"hm_{p}"]) for p in PARTS}
        regs = {p: out.get(f"reg_{p}") for p in PARTS[:4]}
        return exct_decode(
            heats["t"], heats["l"], heats["b"], heats["r"], heats["c"],
            t_regr=regs["t"], l_regr=regs["l"], b_regr=regs["b"],
            r_regr=regs["r"], k=min(cfg.K, 40), num_dets=cfg.K)

    def _post(self, dets_host, meta, scale):
        """The box corners and the 4 extreme points back to source-image
        coordinates, split by class: [bbox 4, score, 8 extreme coords]."""
        d = dets_host[0].copy()
        trans = get_affine_transform(
            meta["c"], meta["s"], 0,
            (meta["out_width"], meta["out_height"]), inv=True)
        for sl in (slice(0, 4), slice(5, 13)):
            pts = d[:, sl].reshape(-1, 2)
            d[:, sl] = (pts @ trans[:, :2].T + trans[:, 2]).reshape(
                d.shape[0], -1)
        classes = d[:, -1]
        top = {}
        for j in range(self.num_classes):
            inds = classes == j
            top[j + 1] = np.concatenate(
                [d[inds, :5], d[inds, 5:13]], axis=1).astype(np.float32)
            top[j + 1][:, :4] /= scale
            top[j + 1][:, 5:] /= scale
        return top

    def merge_outputs(self, detections):
        """(ref detectors/exdet.py:97-122): drop the lattice's penalised
        combinations (score <= 0), soft-NMS always, cut the rows to 5
        columns, then the global top-K score cut."""
        results = {}
        for j in range(1, self.num_classes + 1):
            rows = np.concatenate(
                [d[j] for d in detections], axis=0).astype(np.float32)
            rows = rows[rows[:, 4] > 0]
            soft_nms(rows, nt=0.5, method=2)
            results[j] = rows[:, :5]
        scores = np.hstack(
            [results[j][:, 4] for j in range(1, self.num_classes + 1)])
        if len(scores) > self.max_per_image:
            kth = len(scores) - self.max_per_image
            thresh = np.partition(scores, kth)[kth]
            for j in range(1, self.num_classes + 1):
                results[j] = results[j][results[j][:, 4] >= thresh]
        return results
