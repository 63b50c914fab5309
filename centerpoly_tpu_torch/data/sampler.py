"""GT encoder: one image + annotations -> fixed-shape training arrays.

The port's copy of the JAX package's data/sampler.py (reference
src/lib/datasets/sample/polydet.py:66-450, the polydet `__getitem__`).
Host-side numpy; outputs are NHWC / channel-last, as the loss takes them.

Per image: random-crop centre/scale jitter, hflip with canonical vertex
re-ordering, PCA colour aug; targets: class heatmap (elliptical gaussian
at the polygon centroid), poly offsets (cartesian (dx, dy) or polar
(r, theta)), pseudo_depth, sub-pixel reg, flat peak ind, reg_mask (zeroed
for angle-inverted polar objects), wh, peak, freq_mask, and the maps no
polydet loss reads: border_hm (a gaussian at every GT vertex), fg (the
frame's Cityscapes instance-id image, nearest-resized to the output),
cat_spec_poly / cat_spec_mask under `cat_spec_poly`, and dense_poly /
dense_poly_mask in place of poly under `dense_poly`.
"""
from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np

from ..geometry.affine import affine_transform_points, get_affine_transform
from ..geometry.gaussian import (draw_dense_reg, gaussian_radius,
                                 splat_ellipse_gaussian, splat_gaussian)
from ..utils.png import read_png
from .base_sampler import BaseSampler


def flip_vertex_permutation(n2: int) -> np.ndarray:
    """Index permutation applied to an x-flipped vertex list so traversal
    stays canonical (ref sample/polydet.py:177-186)."""
    perm = np.arange(n2)
    first_angle = n2 // 4
    for i in range(0, n2 // 4 + 2, 2):
        perm[i] = first_angle - i
        perm[i + 1] = first_angle - i + 1
    for i in range(2, 3 * n2 // 4, 2):
        perm[first_angle + i] = n2 - i
        perm[first_angle + i + 1] = n2 - i + 1
    return perm


def resize_nearest(a: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(a, (out_w, out_h), interpolation=cv2.INTER_NEAREST):
    output index i reads input index min(floor(i / (out / in)), in - 1)
    on each axis, the scale's inverse taken in double as cv2 takes it."""
    in_h, in_w = a.shape[:2]
    fy, fx = 1.0 / (out_h / in_h), 1.0 / (out_w / in_w)
    ys = np.minimum(np.floor(np.arange(out_h) * fy).astype(np.int64),
                    in_h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * fx).astype(np.int64),
                    in_w - 1)
    return a[ys[:, None], xs[None, :]]


class PolydetSampler(BaseSampler):
    """Polydet GT encoder; augmentation pipeline shared via BaseSampler.
    Every key of the JAX package's sampler, bit for bit."""

    fallback_hw = (1024, 2048)  # cityscapes frame

    def _fg_mask(self, img_id: int, output_h: int,
                 output_w: int) -> np.ndarray:
        """Binary foreground map from the instance-id image beside the
        frame (ref sample/polydet.py:70-74,153-154: the file name with
        leftImg8bit -> gtFine_instanceIds), read by utils/png.py and
        nearest-resized to the output; zeros where the name has no
        leftImg8bit or the file is absent.  A PNG the reader refuses
        raises."""
        fg = np.zeros((output_h, output_w, 1), np.float32)
        name = self.coco.load_img(img_id).get("file_name", "")
        inst_path = name.replace("leftImg8bit", "gtFine_instanceIds")
        path = os.path.join(self.img_dir or "", inst_path)
        if inst_path != name and os.path.isfile(path):
            m = resize_nearest(read_png(path), output_h, output_w)
            fg[:, :, 0] = (m != 0).astype(np.float32)
        return fg

    def __call__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img_id = self.images[index]
        anns = self.coco.load_anns(img_id)
        num_objs = min(len(anns), cfg.max_objs)
        num_points = cfg.nbr_points
        img = self._load_image(img_id)
        height, width = img.shape[:2]
        input_h, input_w = cfg.input_h, cfg.input_w

        img, c, s, flipped = self._augment_geometry(img)
        inp = self._warp_input(img, c, s)

        output_h = input_h // cfg.down_ratio
        output_w = input_w // cfg.down_ratio
        num_classes = cfg.num_classes
        trans_output = get_affine_transform(c, s, 0, (output_w, output_h))

        hm = np.zeros((output_h, output_w, num_classes), np.float32)
        wh = np.zeros((cfg.max_objs, 2), np.float32)
        border_hm = np.zeros((output_h, output_w, 1), np.float32)
        pseudo_depth = np.zeros((cfg.max_objs, 1), np.float32)
        poly = np.zeros((cfg.max_objs, num_points * 2), np.float32)
        dense_poly = np.zeros((output_h, output_w, num_points * 2),
                              np.float32)
        cat_spec_poly = np.zeros(
            (cfg.max_objs, num_classes * num_points * 2), np.float32)
        cat_spec_mask = np.zeros(
            (cfg.max_objs, num_classes * num_points * 2), np.float32)
        reg = np.zeros((cfg.max_objs, 2), np.float32)
        ind = np.zeros((cfg.max_objs,), np.int32)
        peak = np.zeros((cfg.max_objs, 2), np.float32)
        reg_mask = np.zeros((cfg.max_objs,), np.float32)
        freq_mask = np.zeros((cfg.max_objs,), np.float32)

        flip_perm = flip_vertex_permutation(num_points * 2)
        gt_det = []
        for k in range(num_objs):
            ann = anns[k]
            bbox = np.array([
                ann["bbox"][0], ann["bbox"][1],
                ann["bbox"][0] + ann["bbox"][2],
                ann["bbox"][1] + ann["bbox"][3]], np.float32)
            pseudo_depth[k] = ann["pseudo_depth"]
            cls_id = int(self.meta.cat_ids[ann["category_id"]])
            cls_name = self.meta.class_name[ann["category_id"]]

            pts = np.array(ann["poly"], np.float32).copy()
            if flipped:
                bbox[[0, 2]] = width - bbox[[2, 0]] - 1
                pts[0::2] = width - pts[0::2] - 1
                if not cfg.no_reorder_flip:
                    pts = pts[flip_perm]

            v = pts.reshape(-1, 2)
            v = affine_transform_points(v, trans_output)
            v[:, 0] = np.clip(v[:, 0], 0, output_w - 1)
            v[:, 1] = np.clip(v[:, 1], 0, output_h - 1)

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

            # center = polygon centroid (ref :206-212), not bbox center
            ct = v.mean(axis=0).astype(np.float32)
            ct_int = ct.astype(np.int32)

            if cfg.elliptical_gt:
                radius_x = radius if h > w else int(radius * (w / h))
                radius_y = radius if w >= h else int(radius * (h / w))
                splat_ellipse_gaussian(hm[:, :, cls_id], ct_int,
                                       radius_x, radius_y)
            else:
                splat_gaussian(hm[:, :, cls_id], ct_int, radius)

            wh[k] = w, h
            # border heatmap: a gaussian at every GT vertex (ref :234-236)
            for vx, vy in v:
                splat_gaussian(border_hm[:, :, 0],
                               (int(vx), int(vy)), radius)
            d = v - ct[None, :]
            if cfg.rep == "cartesian":
                poly[k] = d.reshape(-1)
            else:  # polar / polar_fixed (ref :255-284)
                x, y = d[:, 0], d[:, 1]
                r = np.sqrt(x * x + y * y)
                theta = np.arctan((y + 1e-8) / (x + 1e-8))
                theta = np.where(x < 0, theta + np.pi,
                                 np.where(y < 0, theta + 2 * np.pi, theta))
                poly[k, 0::2] = r
                poly[k, 1::2] = theta
            if cfg.cat_spec_poly:
                # per-class polygon channels (ref :245-248, 288-291)
                base = cls_id * num_points * 2
                cat_spec_poly[k, base:base + num_points * 2] = poly[k]
                cat_spec_mask[k, base:base + num_points * 2] = 1
            if cfg.dense_poly:
                # splat the vertex vector where this object's gaussian
                # dominates (ref :401-406)
                draw_dense_reg(dense_poly, hm.max(axis=2), ct_int,
                               poly[k], radius)

            peak[k] = ct
            ind[k] = ct_int[1] * output_w + ct_int[0]
            reg[k] = ct - ct_int
            # polar objects with inverted leading angles are masked out
            # (ref :394-398)
            if cfg.rep == "polar" and poly[k, 1] > poly[k, 5]:
                reg_mask[k] = 0
            else:
                reg_mask[k] = 1
            freq_mask[k] = self.meta.class_frequencies.get(cls_name, 0.0)
            gt_det.append([ct[0] - w / 2, ct[1] - h / 2,
                           ct[0] + w / 2, ct[1] + h / 2, 1, cls_id])

        nz = np.count_nonzero(freq_mask)
        freq_mean = 1.0 if nz == 0 else float(freq_mask.sum() / nz)

        ret = {
            "input": inp,
            "hm": hm,
            "reg_mask": reg_mask,
            "ind": ind,
            "poly": poly,
            "pseudo_depth": pseudo_depth,
            "wh": wh,
            "peak": peak,
            "freq_mask": np.float32(freq_mean),
            "border_hm": border_hm,
            "fg": self._fg_mask(img_id, output_h, output_w),
        }
        if cfg.cat_spec_poly:
            ret["cat_spec_poly"] = cat_spec_poly
            ret["cat_spec_mask"] = cat_spec_mask
        if cfg.dense_poly:
            ret["dense_poly"] = dense_poly
            ret["dense_poly_mask"] = (dense_poly != 0).astype(np.float32)
            del ret["poly"]
        if cfg.reg_offset:
            ret["reg"] = reg
        if self.split != "train":
            gt = (np.array(gt_det, np.float32) if gt_det
                  else np.zeros((1, 6), np.float32))
            ret["meta"] = {"c": c, "s": s, "gt_det": gt, "img_id": img_id,
                           "out_width": input_w, "out_height": input_h}
        return ret
