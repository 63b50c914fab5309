"""Detectors of the ddd, multi_pose and exdet tasks: the port's copy of
the JAX package's infer/task_detectors.py (reference src/lib/detectors/
{ddd,multi_pose,exdet}.py).  All share BaseDetector's run loop (`run`,
`run_batch`, `run_stream`); each gives its decode of the head maps on
the device and its host post-process and merge.

ddd rows are [alpha, x0, y0, x1, y1, dim 3 (h, w, l), location 3,
rotation_y, score] a class (KittiMeta's writer's order); multi_pose rows
are [x0, y0, x1, y1, score, 17 (x, y) joints] under class 1; exdet's
merged rows are [x0, y0, x1, y1, score] a class.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..data.multi_pose_sampler import FLIP_IDX
from ..geometry.affine import get_affine_transform, transform_preds
from ..geometry.ddd import DEFAULT_CALIB, ddd2locrot, get_alpha
from ..losses.ddd import ddd_depth_transform
from ..losses.exdet import PARTS
from ..ops.decode import ddd_decode, exct_decode, multi_pose_decode
from ..ops.nms import soft_nms, soft_nms_39
from .detector import BaseDetector


def ddd_post_process_2d(dets: np.ndarray, c, s, out_hw, num_classes: int
                        ) -> List[Dict[int, np.ndarray]]:
    """Decoded ddd rows (B, K, 16 or 18) -> per image and class [x, y,
    score, alpha, depth, dim 3, (wh 2)] with the centre (and wh) back in
    source-image coordinates (ref post_process.py:25-49).  Writes the
    centres into `dets`: pass a copy."""
    out_h, out_w = out_hw
    ret = []
    include_wh = dets.shape[2] > 16
    for i in range(dets.shape[0]):
        top = {}
        dets[i, :, :2] = transform_preds(
            dets[i, :, 0:2], c[i], s[i], (out_w, out_h))
        classes = dets[i, :, -1]
        for j in range(num_classes):
            inds = classes == j
            top[j + 1] = np.concatenate([
                dets[i, inds, :3].astype(np.float32),
                get_alpha(dets[i, inds, 3:11])[:, None].astype(np.float32),
                dets[i, inds, 11:12].astype(np.float32),
                dets[i, inds, 12:15].astype(np.float32)], axis=1)
            if include_wh:
                top[j + 1] = np.concatenate([
                    top[j + 1],
                    transform_preds(dets[i, inds, 15:17], c[i], s[i],
                                    (out_w, out_h)).astype(np.float32)],
                    axis=1)
        ret.append(top)
    return ret


def ddd_post_process_3d(dets, calibs) -> List[Dict[int, np.ndarray]]:
    """ddd_post_process_2d's rows -> [alpha, bbox 4, dim 3, location 3,
    rotation_y, score] (13 columns), lifted to 3D through the first
    calibration (ref post_process.py:51-77).  Rows without wh
    (reg_bbox=False) get a point box at their centre, as in the JAX
    package, where the reference raises IndexError."""
    ret = []
    for i in range(len(dets)):
        preds = {}
        for cls_ind in dets[i].keys():
            rows = []
            for row in dets[i][cls_ind]:
                center, score, alpha, depth = row[:2], row[2], row[3], row[4]
                dimensions = row[5:8]
                wh = row[8:10] if row.shape[0] >= 10 else np.zeros(
                    2, np.float32)
                locations, rotation_y = ddd2locrot(
                    center, alpha, dimensions, depth, calibs[0])
                bbox = [center[0] - wh[0] / 2, center[1] - wh[1] / 2,
                        center[0] + wh[0] / 2, center[1] + wh[1] / 2]
                rows.append([alpha] + bbox + dimensions.tolist()
                            + locations.tolist() + [rotation_y, score])
            preds[cls_ind] = np.array(rows, dtype=np.float32)
        ret.append(preds)
    return ret


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


class DddDetector(BaseDetector):
    """Monocular 3D box detector (ref detectors/ddd.py).

    The frame is mapped whole onto the input canvas, anisotropically
    (`pre_process_meta`), at every test scale alike: the reference's
    pre_process ignores the scale.  (The JAX package folds the scale into
    the warp, as for the other tasks, but maps the rows back with the
    unscaled c and s, so its rows move at a scale other than 1; the port
    does not copy that.)  flip_tta is off: the reference's ddd
    pre-process never adds the flipped half, so --flip_test runs a batch
    of B and gives the plain results."""

    flip_tta = False

    def __init__(self, cfg, variables=None, calib: np.ndarray | None = None,
                 **kw):
        super().__init__(cfg, variables=variables, **kw)
        self.calib = DEFAULT_CALIB if calib is None else np.asarray(
            calib, np.float32)

    def pre_process_meta(self, height: int, width: int, scale: float):
        """The source frame onto the input canvas, s = [width, height]
        (ref detectors/ddd.py:31-55); `scale` is not read."""
        cfg = self.cfg
        inp_h, inp_w = cfg.input_h, cfg.input_w
        c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
        s = np.array([width, height], dtype=np.float32)
        trans = get_affine_transform(c, s, 0, (inp_w, inp_h))
        meta = {"c": c, "s": s, "inp_h": inp_h, "inp_w": inp_w,
                "out_height": inp_h // cfg.down_ratio,
                "out_width": inp_w // cfg.down_ratio}
        return trans, meta

    def _scaled_trans(self, h: int, w: int, scale: float):
        """Every scale warps the frame as scale 1 does: `pre_process_meta`
        is defined on the frame itself, not on a resized copy, so no
        scale is folded in."""
        return self.pre_process_meta(h, w, scale)

    def _decode(self, heads):
        cfg = self.cfg
        out = {k: v.float().permute(0, 2, 3, 1)
               for k, v in heads.items()}                       # NHWC views
        return ddd_decode(
            torch.sigmoid(out["hm"]), out["rot"],
            ddd_depth_transform(out["dep"]), out["dim"],
            wh=out["wh"] if cfg.reg_bbox else None,
            reg=out["reg"] if cfg.reg_offset else None, k=cfg.K)

    def _post(self, dets_host, meta, scale):
        d2 = ddd_post_process_2d(
            dets_host[:1].copy(), [meta["c"]], [meta["s"]],
            (meta["out_height"], meta["out_width"]), self.num_classes)
        return ddd_post_process_3d(d2, [self.calib])[0]

    def merge_outputs(self, detections):
        """The first scale's rows, cut at peak_thresh on the score (the
        last column; ref detectors/ddd.py:84-90)."""
        results = detections[0]
        for j in range(1, self.num_classes + 1):
            if len(results[j]) > 0:
                results[j] = results[j][results[j][:, -1]
                                        > self.cfg.peak_thresh]
        return results
