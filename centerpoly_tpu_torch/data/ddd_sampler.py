"""GT encoder of the ddd (monocular 3D box) task: the port's copy of the
JAX package's data/ddd_sampler.py (reference src/lib/datasets/sample/
ddd.py:27-170).  The frame is mapped whole onto the input canvas with
an anisotropic scale s = [width, height] (`get_affine_transform` reads
s[0] only, as the reference's does); in the train split, with
probability aug_ddd, a scale and a shift jitter it, and then reg_mask is
0 (the depth is no longer the frame's) while rot_mask stays 1.  Per
object: the centre heat map, depth, the multi-bin rotation (two bins,
each a label and a residual), the dimensions, wh and the sub-pixel
offset.  An ignore region (cls_id < 0: -1 stamps every class, -2 / -3
class -cls_id - 2) ends in 0.9999 at its centre; cls_id <= -99 is
skipped.  Each annotation keeps its own slot k.  Host-side numpy, NHWC
outputs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..geometry.affine import affine_transform_points, get_affine_transform
from ..geometry.gaussian import (gaussian_radius, splat_gaussian,
                                 splat_msra_gaussian)
from .base_sampler import BaseSampler

def alpha_to_8(alpha: float) -> list:
    """The multi-bin rotation target of an observation angle (ref
    sample/ddd.py:160-170): [bin1 (0, 1), sin, cos, bin2 (0, 1), sin,
    cos], each bin set where alpha lies in its (overlapping) range."""
    ret = [0, 0, 0, 1, 0, 0, 0, 1]
    if alpha < np.pi / 6.0 or alpha > 5 * np.pi / 6.0:
        r = alpha - (-0.5 * np.pi)
        ret[1] = 1
        ret[2], ret[3] = np.sin(r), np.cos(r)
    if alpha > -np.pi / 6.0 or alpha < -5 * np.pi / 6.0:
        r = alpha - (0.5 * np.pi)
        ret[5] = 1
        ret[6], ret[7] = np.sin(r), np.cos(r)
    return ret


class DddSampler(BaseSampler):
    """ddd GT encoder: hm, dep, dim, ind, rotbin, rotres, reg_mask,
    rot_mask, wh and, with reg_offset, reg; the val split's meta carries
    c, s, img_id and gt_det rows [x, y, 1, rot 8, depth, dim 3, class]
    (16 columns; zeros (1, 18) for a frame with none)."""

    def __call__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self.rng
        img_id = self.images[index]
        anns = self.coco.load_anns(img_id)
        num_objs = min(len(anns), cfg.max_objs)
        img = self._load_image(img_id)
        height, width = img.shape[:2]

        c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
        s = np.array([width, height], dtype=np.float32)
        aug = False
        if self.split == "train" and rng.random_sample() < cfg.aug_ddd:
            aug = True
            sf, cf = cfg.scale, cfg.shift
            s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            c[0] += width * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
            c[1] += height * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)

        inp = self._warp_input(img, c, s)

        output_h = cfg.input_h // cfg.down_ratio
        output_w = cfg.input_w // cfg.down_ratio
        num_classes = cfg.num_classes
        trans_output = get_affine_transform(c, s, 0, (output_w, output_h))

        hm = np.zeros((output_h, output_w, num_classes), np.float32)
        wh = np.zeros((cfg.max_objs, 2), np.float32)
        reg = np.zeros((cfg.max_objs, 2), np.float32)
        dep = np.zeros((cfg.max_objs, 1), np.float32)
        rotbin = np.zeros((cfg.max_objs, 2), np.int32)
        rotres = np.zeros((cfg.max_objs, 2), np.float32)
        dim = np.zeros((cfg.max_objs, 3), np.float32)
        ind = np.zeros((cfg.max_objs,), np.int32)
        reg_mask = np.zeros((cfg.max_objs,), np.float32)
        rot_mask = np.zeros((cfg.max_objs,), np.float32)

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
            cls_id = int(self.meta.cat_ids[ann["category_id"]])
            if cls_id <= -99:
                continue
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
            radius = max(0, int(gaussian_radius((h, w))))
            ct = np.array([(bbox[0] + bbox[2]) / 2,
                           (bbox[1] + bbox[3]) / 2], np.float32)
            ct_int = ct.astype(np.int32)
            if cls_id < 0:
                # an ignore region: near 1 at its centre, so the focal
                # loss neither rewards nor punishes a peak there
                ignore = (list(range(num_classes)) if cls_id == -1
                          else [-cls_id - 2])
                for cc in ignore:
                    draw(hm[:, :, cc], ct_int, radius)
                    hm[ct_int[1], ct_int[0], cc] = 0.9999
                continue
            draw(hm[:, :, cls_id], ct_int, radius)
            wh[k] = w, h
            alpha = float(ann["alpha"])
            gt_det.append([ct[0], ct[1], 1] + alpha_to_8(alpha)
                          + [ann["depth"]] + list(ann["dim"]) + [cls_id])
            if alpha < np.pi / 6.0 or alpha > 5 * np.pi / 6.0:
                rotbin[k, 0] = 1
                rotres[k, 0] = alpha - (-0.5 * np.pi)
            if alpha > -np.pi / 6.0 or alpha < -5 * np.pi / 6.0:
                rotbin[k, 1] = 1
                rotres[k, 1] = alpha - (0.5 * np.pi)
            dep[k] = ann["depth"]
            dim[k] = ann["dim"]
            ind[k] = ct_int[1] * output_w + ct_int[0]
            reg[k] = ct - ct_int
            reg_mask[k] = 0 if aug else 1
            rot_mask[k] = 1

        ret = {"input": inp, "hm": hm, "dep": dep, "dim": dim, "ind": ind,
               "rotbin": rotbin, "rotres": rotres, "reg_mask": reg_mask,
               "rot_mask": rot_mask, "wh": wh}
        if cfg.reg_offset:
            ret["reg"] = reg
        if self.split != "train":
            # a row has 16 columns; a frame without one gets the
            # reference's (1, 18) of zeros
            gt = (np.array(gt_det, np.float32) if gt_det
                  else np.zeros((1, 18), np.float32))
            ret["meta"] = {"c": c, "s": s, "gt_det": gt, "img_id": img_id}
        return ret
