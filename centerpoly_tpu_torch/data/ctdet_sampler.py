"""GT encoder of the ctdet (CenterNet box detection) task: the port's copy
of the JAX package's data/ctdet_sampler.py (reference
src/lib/datasets/sample/ctdet.py:29-199).  The augmentation is polydet's
(BaseSampler: random crop, hflip, colour aug); the targets are box-centred
gaussians and wh regression.  Host-side numpy, NHWC outputs; frames come
through utils/png.py::read_image (no cv2 for `.npy` and PNG).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..geometry.affine import affine_transform_points, get_affine_transform
from ..geometry.gaussian import (draw_dense_reg, gaussian_radius,
                                 splat_ellipse_gaussian, splat_gaussian,
                                 splat_msra_gaussian)
from .base_sampler import BaseSampler


class CtdetSampler(BaseSampler):
    """ctdet GT encoder: hm, wh, reg, ind, reg_mask; under dense_wh
    (dense_wh, dense_wh_mask) and under cat_spec_wh (cat_spec_wh,
    cat_spec_mask) each in place of wh; the val split's meta carries
    gt_det rows [x0, y0, x1, y1, 1, class]."""

    def __call__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img_id = self.images[index]
        anns = self.coco.load_anns(img_id)
        num_objs = min(len(anns), cfg.max_objs)
        img = self._load_image(img_id)
        height, width = img.shape[:2]

        img, c, s, flipped = self._augment_geometry(img)
        inp = self._warp_input(img, c, s)

        output_h = cfg.input_h // cfg.down_ratio
        output_w = cfg.input_w // cfg.down_ratio
        num_classes = cfg.num_classes
        trans_output = get_affine_transform(c, s, 0, (output_w, output_h))

        hm = np.zeros((output_h, output_w, num_classes), np.float32)
        wh = np.zeros((cfg.max_objs, 2), np.float32)
        dense_wh = np.zeros((output_h, output_w, 2), np.float32)
        reg = np.zeros((cfg.max_objs, 2), np.float32)
        ind = np.zeros((cfg.max_objs,), np.int32)
        reg_mask = np.zeros((cfg.max_objs,), np.float32)
        cat_spec_wh = np.zeros((cfg.max_objs, num_classes * 2), np.float32)
        cat_spec_mask = np.zeros((cfg.max_objs, num_classes * 2), np.float32)

        gt_det = []
        for k in range(num_objs):
            ann = anns[k]
            bbox = np.array([
                ann["bbox"][0], ann["bbox"][1],
                ann["bbox"][0] + ann["bbox"][2],
                ann["bbox"][1] + ann["bbox"][3]], np.float32)
            cls_id = int(self.meta.cat_ids[ann["category_id"]])
            if flipped:
                bbox[[0, 2]] = width - bbox[[2, 0]] - 1
            bbox[:2] = affine_transform_points(bbox[None, :2],
                                               trans_output)[0]
            bbox[2:] = affine_transform_points(bbox[None, 2:],
                                               trans_output)[0]
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, output_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, output_h - 1)
            h = bbox[3] - bbox[1]
            w = bbox[2] - bbox[0]
            if h <= 0 or w <= 0:
                continue
            radius = max(0, int(gaussian_radius(
                (math.ceil(h), math.ceil(w)))))
            ct = np.array([(bbox[0] + bbox[2]) / 2,
                           (bbox[1] + bbox[3]) / 2], np.float32)
            ct_int = ct.astype(np.int32)

            if cfg.elliptical_gt:
                radius_x = radius if h > w else int(radius * (w / h))
                radius_y = radius if w >= h else int(radius * (h / w))
                splat_ellipse_gaussian(hm[:, :, cls_id], ct_int,
                                       radius_x, radius_y)
            elif cfg.mse_loss:
                splat_msra_gaussian(hm[:, :, cls_id], ct_int, cfg.hm_gauss)
            else:
                splat_gaussian(hm[:, :, cls_id], ct_int, radius)

            wh[k] = w, h
            ind[k] = ct_int[1] * output_w + ct_int[0]
            reg[k] = ct - ct_int
            reg_mask[k] = 1
            cat_spec_wh[k, cls_id * 2: cls_id * 2 + 2] = wh[k]
            cat_spec_mask[k, cls_id * 2: cls_id * 2 + 2] = 1
            if cfg.dense_wh:
                draw_dense_reg(dense_wh, hm.max(axis=2), ct_int, wh[k],
                               radius)
            gt_det.append([ct[0] - w / 2, ct[1] - h / 2,
                           ct[0] + w / 2, ct[1] + h / 2, 1, cls_id])

        ret = {"input": inp, "hm": hm, "reg_mask": reg_mask, "ind": ind,
               "wh": wh}
        if cfg.dense_wh:
            hm_a = hm.max(axis=2, keepdims=True)
            ret["dense_wh"] = dense_wh
            ret["dense_wh_mask"] = np.concatenate([hm_a, hm_a], axis=2)
            del ret["wh"]
        elif cfg.cat_spec_wh:
            ret["cat_spec_wh"] = cat_spec_wh
            ret["cat_spec_mask"] = cat_spec_mask
            del ret["wh"]
        if cfg.reg_offset:
            ret["reg"] = reg
        if self.split != "train":
            gt = (np.array(gt_det, np.float32) if gt_det
                  else np.zeros((1, 6), np.float32))
            ret["meta"] = {"c": c, "s": s, "gt_det": gt, "img_id": img_id}
        return ret
