"""Shared GT-encoder machinery (the JAX package's data/base_sampler.py):
random crop via centre/scale jitter, horizontal flip, the affine input
warp, PCA colour aug and normalisation.  Host-side numpy; NHWC outputs.

The input warp is the port's own, with no cv2: an affine with no rotation
(rot=0, every task but multi_pose under aug_rot) is axis-aligned and
separable, and `warp_axis_aligned_np` computes it as two two-tap gathers
(rows, then columns) with the arithmetic of
geometry/affine.py::_sampling_matrix; a rotated one goes through
geometry/affine.py::warp_affine_np, the JAX package's general bilinear
warp in numpy.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..geometry.affine import get_affine_transform, warp_affine_np
from ..utils.png import read_image
from .coco_poly import CocoPolyAnnotations

# Cityscapes PCA colour-aug eigen decomposition
# (ref dataset/cityscapes.py:101-107)
EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], dtype=np.float32)
EIG_VEC = np.array([
    [-0.58752847, -0.69563484, 0.41340352],
    [-0.5832747, 0.00994535, -0.81221408],
    [-0.56089297, 0.71832671, 0.41158938],
], dtype=np.float32)


def color_aug(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """CornerNet-style brightness/contrast/saturation + PCA lighting
    (ref utils/image.py:234-263). img float32 [0,1] HWC, modified copy."""
    img = img.copy()
    gs = img.mean(axis=2)
    gs_mean = gs.mean()

    def brightness(a):
        img[:] *= a

    def contrast(a):
        img[:] = img * a + gs_mean * (1 - a)

    def saturation(a):
        img[:] = img * a + gs[:, :, None] * (1 - a)

    fns = [brightness, contrast, saturation]
    order = rng.permutation(3)
    for i in order:
        alpha = 1.0 + rng.uniform(-0.4, 0.4)
        fns[i](alpha)
    alpha = rng.normal(scale=0.1, size=(3,))
    img += EIG_VEC @ (EIG_VAL * alpha)
    return img


def _get_border(border: int, size: int) -> int:
    i = 1
    while size - border // i <= border // i:
        i *= 2
    return border // i


def _taps(out_size: int, in_size: int, scale, shift):
    """The two nonzero taps of each row of _sampling_matrix(out, in):
    source rows (2, out) clipped into the image and their weights
    max(0, 1 - |src - i|) in f32, 0 for a tap outside the image."""
    src = ((np.arange(out_size, dtype=np.float32) - np.float32(shift))
           / np.float32(scale))
    i0 = np.floor(src)
    pos = np.stack([i0, i0 + 1])
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(src - pos))
    idx = pos.astype(np.int64)
    inside = (idx >= 0) & (idx < in_size)
    return np.clip(idx, 0, in_size - 1), np.where(inside, w, 0).astype(
        np.float32)


def warp_axis_aligned_np(image: np.ndarray, trans, out_hw) -> np.ndarray:
    """Axis-aligned affine warp of an HWC image for trans = [[ax, 0, tx],
    [0, ay, ty]] (source -> output), bilinear, zero outside: what
    geometry/affine.py::warp_axis_aligned computes as W_y @ image @ W_x^T,
    here as a row gather then a column gather of two taps each.
    Returns (out_h, out_w, C) float32."""
    trans = np.asarray(trans, np.float32)
    out_h, out_w = out_hw
    in_h, in_w = image.shape[:2]
    iy, wy = _taps(out_h, in_h, trans[1, 1], trans[1, 2])
    ix, wx = _taps(out_w, in_w, trans[0, 0], trans[0, 2])
    img = image.astype(np.float32)
    rows = img[iy[0]] * wy[0][:, None, None] + img[iy[1]] * wy[1][:, None, None]
    return (rows[:, ix[0]] * wx[0][None, :, None]
            + rows[:, ix[1]] * wx[1][None, :, None])


class BaseSampler:
    """Callable GT encoder bound to a dataset + config."""

    # image dims of the noise fallback when the annotation omits them
    fallback_hw = (512, 512)

    def __init__(self, cfg, meta, annotations: CocoPolyAnnotations,
                 split: str = "train", img_dir: Optional[str] = None,
                 seed: int = 123):
        self.cfg = cfg
        self.meta = meta
        self.coco = annotations
        self.split = split
        self.img_dir = img_dir
        self.images = annotations.get_img_ids()
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.images)

    def _load_image(self, img_id: int) -> np.ndarray:
        """An HWC uint8 frame through utils/png.py::read_image (`.npy`
        with numpy, PNG in numpy, JPEG with cv2, which raises where cv2 is
        missing); a missing file, or one that cv2 cannot decode, gives the
        JAX package's deterministic noise of the annotated size.  A PNG
        the numpy reader refuses raises: it may be one cv2 would read."""
        info = self.coco.load_img(img_id)
        path = os.path.join(self.img_dir or "", info["file_name"])
        if os.path.isfile(path):
            try:
                return read_image(path)
            except ValueError:
                if path.lower().endswith((".png", ".npy")):
                    raise
        h = info.get("height", self.fallback_hw[0])
        w = info.get("width", self.fallback_hw[1])
        r = np.random.RandomState(img_id % (2 ** 31))
        return (r.rand(h, w, 3) * 255).astype(np.uint8)

    def _augment_geometry(self, img: np.ndarray, allow_flip: bool = True
                          ) -> Tuple[np.ndarray, np.ndarray, float, bool]:
        """Random crop jitter + flip (ref sample/ctdet.py:51-72).
        Returns (img, center, scale, flipped)."""
        cfg = self.cfg
        rng = self.rng
        height, width = img.shape[:2]
        c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
        s = max(height, width) * 1.0
        flipped = False
        if self.split == "train":
            if not cfg.not_rand_crop:
                s = s * rng.choice(np.arange(0.6, 1.4, 0.1))
                w_border = _get_border(128, width)
                h_border = _get_border(128, height)
                c[0] = rng.randint(low=w_border, high=width - w_border)
                c[1] = rng.randint(low=h_border, high=height - h_border)
            else:
                sf, cf = cfg.scale, cfg.shift
                c[0] += s * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
                c[1] += s * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
                s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            if allow_flip and rng.random_sample() < cfg.flip:
                flipped = True
                img = img[:, ::-1, :]
                c[0] = width - c[0] - 1
        return img, c, s, flipped

    def _warp_input(self, img: np.ndarray, c, s, rot: float = 0.0
                    ) -> np.ndarray:
        """Warp to (input_h, input_w), rotated by `rot` degrees, + colour
        aug + normalise."""
        cfg = self.cfg
        input_h, input_w = cfg.input_h, cfg.input_w
        trans_input = get_affine_transform(c, s, rot, (input_w, input_h))
        warp = warp_axis_aligned_np if rot == 0 else warp_affine_np
        inp = warp(img, trans_input, (input_h, input_w))
        inp = inp / np.float32(255.0)
        if self.split == "train" and not cfg.no_color_aug:
            inp = color_aug(self.rng, inp)
        return (inp - np.asarray(cfg.mean, np.float32)) / np.asarray(
            cfg.std, np.float32)
