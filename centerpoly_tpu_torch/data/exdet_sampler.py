"""GT encoder of the exdet (ExtremeNet) task: the port's copy of the JAX
package's data/exdet_sampler.py (reference src/lib/datasets/sample/
exdet.py:30-136).  The augmentation is BaseSampler's (random crop, hflip,
colour aug); per object, four extreme-point heat maps (one channel a
class, or one in all with agnostic_ex) and a centre heat map, the
extreme points' sub-pixel offsets and flat indices.  An annotation
without `extreme_points` takes its box's edge midpoints.  Host-side
numpy, NHWC outputs.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..geometry.affine import affine_transform_points, get_affine_transform
from ..geometry.gaussian import (gaussian_radius, splat_gaussian,
                                 splat_msra_gaussian)
from .base_sampler import BaseSampler

EDGES = ("t", "l", "b", "r")


class ExdetSampler(BaseSampler):
    """exdet GT encoder: hm_{t,l,b,r,c} and, with reg_offset, reg_mask,
    reg_{t,l,b,r} and ind_{t,l,b,r}; the val split's meta carries c, s
    and img_id."""

    def __call__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img_id = self.images[index]
        anns = self.coco.load_anns(img_id)
        num_objs = min(len(anns), cfg.max_objs)
        img = self._load_image(img_id)
        width = img.shape[1]

        img, c, s, flipped = self._augment_geometry(img)
        inp = self._warp_input(img, c, s)

        output_h = cfg.input_h // cfg.down_ratio
        output_w = cfg.input_w // cfg.down_ratio
        num_classes = cfg.num_classes
        num_hm = 1 if cfg.agnostic_ex else num_classes
        trans_output = get_affine_transform(c, s, 0, (output_w, output_h))

        hms = {p: np.zeros((output_h, output_w, num_hm), np.float32)
               for p in EDGES}
        hm_c = np.zeros((output_h, output_w, num_classes), np.float32)
        regs = {p: np.zeros((cfg.max_objs, 2), np.float32) for p in EDGES}
        inds = {p: np.zeros((cfg.max_objs,), np.int32) for p in EDGES}
        reg_mask = np.zeros((cfg.max_objs,), np.float32)

        def draw(heatmap, center, radius):
            if cfg.mse_loss:
                splat_msra_gaussian(heatmap, center, cfg.hm_gauss)
            else:
                splat_gaussian(heatmap, center, radius)

        for k in range(num_objs):
            ann = anns[k]
            if "extreme_points" in ann:
                pts = np.array(ann["extreme_points"],
                               np.float32).reshape(4, 2)
            else:
                x0, y0, w0, h0 = ann["bbox"]
                pts = np.array([
                    [x0 + w0 / 2, y0], [x0, y0 + h0 / 2],
                    [x0 + w0 / 2, y0 + h0], [x0 + w0, y0 + h0 / 2]],
                    np.float32)
            cls_id = int(self.meta.cat_ids[ann["category_id"]])
            hm_id = 0 if cfg.agnostic_ex else cls_id
            if flipped:
                pts[:, 0] = width - pts[:, 0] - 1
                pts[1], pts[3] = pts[3].copy(), pts[1].copy()
            pts = affine_transform_points(pts, trans_output).astype(
                np.float32)
            pts[:, 0] = np.clip(pts[:, 0], 0, output_w - 1)
            pts[:, 1] = np.clip(pts[:, 1], 0, output_h - 1)
            h = pts[2, 1] - pts[0, 1]
            w = pts[3, 0] - pts[1, 0]
            if h <= 0 or w <= 0:
                continue
            radius = max(0, int(gaussian_radius(
                (math.ceil(h), math.ceil(w)))))
            pt_int = pts.astype(np.int32)
            for i, p in enumerate(EDGES):
                draw(hms[p][:, :, hm_id], pt_int[i], radius)
                regs[p][k] = pts[i] - pt_int[i]
                inds[p][k] = pt_int[i, 1] * output_w + pt_int[i, 0]
            ct = (int((pts[3, 0] + pts[1, 0]) / 2),
                  int((pts[0, 1] + pts[2, 1]) / 2))
            draw(hm_c[:, :, cls_id], ct, radius)
            reg_mask[k] = 1

        ret = {"input": inp, **{f"hm_{p}": hms[p] for p in EDGES},
               "hm_c": hm_c}
        if cfg.reg_offset:
            ret["reg_mask"] = reg_mask
            for p in EDGES:
                ret[f"reg_{p}"] = regs[p]
                ret[f"ind_{p}"] = inds[p]
        if self.split != "train":
            ret["meta"] = {"c": c, "s": s, "img_id": img_id}
        return ret
