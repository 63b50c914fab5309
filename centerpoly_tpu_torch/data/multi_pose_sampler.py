"""GT encoder of the multi_pose (CenterNet human pose) task: the port's
copy of the JAX package's data/multi_pose_sampler.py (reference
src/lib/datasets/sample/multi_pose.py:29-183).  The centre heat map, wh
and offset, each joint's offset from the centre (masked by its
visibility), the joint heat maps and the joints' sub-pixel offsets.  In
the train split an optional rotation (aug_rot, rotate) warps the input
through geometry/affine.py::warp_affine_np and blanks the centre targets
(hm 0.9999, masks 0), as the reference does.  Host-side numpy, NHWC
outputs.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..geometry.affine import affine_transform_points, get_affine_transform
from ..geometry.gaussian import (draw_dense_reg, gaussian_radius,
                                 splat_gaussian, splat_msra_gaussian)
from .base_sampler import BaseSampler

# COCO's left/right joint pairs, swapped on a horizontal flip
# (ref dataset/coco_hp.py flip_idx)
FLIP_IDX = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
            [15, 16]]


class MultiPoseSampler(BaseSampler):
    """multi_pose GT encoder: hm, wh, reg, ind, reg_mask, hps, hps_mask,
    hm_hp, hp_offset, hp_ind, hp_mask; under dense_hp (dense_hps,
    dense_hps_mask) in place of (hps, hps_mask); the val split's meta
    carries gt_det rows [x0, y0, x1, y1, 1, 34 joint coords, class]."""

    num_joints = 17

    def __call__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self.rng
        img_id = self.images[index]
        anns = self.coco.load_anns(img_id)
        num_objs = min(len(anns), cfg.max_objs)
        img = self._load_image(img_id)
        width = img.shape[1]

        rot = 0.0
        img, c, s, flipped = self._augment_geometry(img)
        # the draw happens in the train split even with aug_rot 0
        if self.split == "train" and rng.random_sample() < cfg.aug_rot:
            rf = cfg.rotate
            rot = float(np.clip(rng.randn() * rf, -rf * 2, rf * 2))
        inp = self._warp_input(img, c, s, rot)

        output_h = cfg.input_h // cfg.down_ratio
        output_w = cfg.input_w // cfg.down_ratio
        num_joints = self.num_joints
        trans_output_rot = get_affine_transform(c, s, rot,
                                                (output_w, output_h))
        trans_output = get_affine_transform(c, s, 0, (output_w, output_h))

        hm = np.zeros((output_h, output_w, cfg.num_classes), np.float32)
        hm_hp = np.zeros((output_h, output_w, num_joints), np.float32)
        dense_kps = np.zeros((num_joints, output_h, output_w, 2), np.float32)
        dense_kps_mask = np.zeros((num_joints, output_h, output_w),
                                  np.float32)
        wh = np.zeros((cfg.max_objs, 2), np.float32)
        kps = np.zeros((cfg.max_objs, num_joints * 2), np.float32)
        reg = np.zeros((cfg.max_objs, 2), np.float32)
        ind = np.zeros((cfg.max_objs,), np.int32)
        reg_mask = np.zeros((cfg.max_objs,), np.float32)
        kps_mask = np.zeros((cfg.max_objs, num_joints * 2), np.float32)
        hp_offset = np.zeros((cfg.max_objs * num_joints, 2), np.float32)
        hp_ind = np.zeros((cfg.max_objs * num_joints,), np.int32)
        hp_mask = np.zeros((cfg.max_objs * num_joints,), np.float32)

        def draw(heatmap, center, radius):
            if cfg.mse_loss:
                splat_msra_gaussian(heatmap, center, cfg.hm_gauss)
            else:
                splat_gaussian(heatmap, center, radius)

        gt_det = []
        for k in range(num_objs):
            ann = anns[k]
            bbox = np.array([
                ann["bbox"][0], ann["bbox"][1],
                ann["bbox"][0] + ann["bbox"][2],
                ann["bbox"][1] + ann["bbox"][3]], np.float32)
            cls_id = int(ann["category_id"]) - 1
            pts = np.array(ann["keypoints"], np.float32).reshape(
                num_joints, 3)
            if flipped:
                bbox[[0, 2]] = width - bbox[[2, 0]] - 1
                pts[:, 0] = width - pts[:, 0] - 1
                for a, b in FLIP_IDX:
                    pts[a], pts[b] = pts[b].copy(), pts[a].copy()
            bbox[:2] = affine_transform_points(bbox[None, :2],
                                               trans_output)[0]
            bbox[2:] = affine_transform_points(bbox[None, 2:],
                                               trans_output)[0]
            bbox = np.clip(bbox, 0, [output_w - 1, output_h - 1,
                                     output_w - 1, output_h - 1])
            h = bbox[3] - bbox[1]
            w = bbox[2] - bbox[0]
            if not ((h > 0 and w > 0) or rot != 0):
                continue
            radius = max(0, int(gaussian_radius(
                (math.ceil(h), math.ceil(w)))))
            ct = np.array([(bbox[0] + bbox[2]) / 2,
                           (bbox[1] + bbox[3]) / 2], np.float32)
            ct_int = ct.astype(np.int32)
            wh[k] = w, h
            ind[k] = ct_int[1] * output_w + ct_int[0]
            reg[k] = ct - ct_int
            reg_mask[k] = 1
            if pts[:, 2].sum() == 0:
                hm[ct_int[1], ct_int[0], cls_id] = 0.9999
                reg_mask[k] = 0
            for j in range(num_joints):
                if pts[j, 2] <= 0:
                    continue
                pts[j, :2] = affine_transform_points(
                    pts[j, None, :2], trans_output_rot)[0]
                if not (0 <= pts[j, 0] < output_w
                        and 0 <= pts[j, 1] < output_h):
                    continue
                kps[k, j * 2: j * 2 + 2] = pts[j, :2] - ct_int
                kps_mask[k, j * 2: j * 2 + 2] = 1
                pt_int = pts[j, :2].astype(np.int32)
                hp_offset[k * num_joints + j] = pts[j, :2] - pt_int
                hp_ind[k * num_joints + j] = pt_int[1] * output_w + pt_int[0]
                hp_mask[k * num_joints + j] = 1
                if cfg.dense_hp:
                    # before the centre gaussian is drawn
                    draw_dense_reg(dense_kps[j], hm[:, :, cls_id], ct_int,
                                   pts[j, :2] - ct_int, radius,
                                   is_offset=True)
                    draw(dense_kps_mask[j], ct_int, radius)
                draw(hm_hp[:, :, j], pt_int, radius)
            draw(hm[:, :, cls_id], ct_int, radius)
            gt_det.append(
                [ct[0] - w / 2, ct[1] - h / 2, ct[0] + w / 2,
                 ct[1] + h / 2, 1]
                + pts[:, :2].reshape(num_joints * 2).tolist() + [cls_id])

        if rot != 0:
            # a rotated crop has no aligned centre targets (ref :158-161)
            hm = hm * 0 + 0.9999
            reg_mask *= 0
            kps_mask *= 0

        ret = {"input": inp, "hm": hm, "reg_mask": reg_mask, "ind": ind,
               "wh": wh, "hps": kps, "hps_mask": kps_mask}
        if cfg.dense_hp:
            # (J, H, W, 2) -> (H, W, 2J); the mask repeated for x and y
            ret["dense_hps"] = dense_kps.transpose(1, 2, 0, 3).reshape(
                output_h, output_w, num_joints * 2)
            m = np.repeat(dense_kps_mask[..., None], 2, axis=-1)
            ret["dense_hps_mask"] = m.transpose(1, 2, 0, 3).reshape(
                output_h, output_w, num_joints * 2)
            del ret["hps"], ret["hps_mask"]
        if cfg.reg_offset:
            ret["reg"] = reg
        if cfg.hm_hp:
            ret["hm_hp"] = hm_hp
        if cfg.reg_hp_offset:
            ret.update({"hp_offset": hp_offset, "hp_ind": hp_ind,
                        "hp_mask": hp_mask})
        if self.split != "train":
            gt = (np.array(gt_det, np.float32) if gt_det
                  else np.zeros((1, 40), np.float32))
            ret["meta"] = {"c": c, "s": s, "gt_det": gt, "img_id": img_id}
        return ret
