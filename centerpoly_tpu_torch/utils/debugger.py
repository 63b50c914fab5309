"""Debug visualizer: heat-map blends and box / polygon / keypoint overlays
(the JAX package's utils/debugger.py; reference src/lib/utils/
debugger.py): an image store keyed by id, colour renders of class heat
maps, the polydet polygon overlay (:214-234), and save_all_imgs for debug
level 4 (opts.py:19-24: 1 = only show, 2 = + pred/gt heat maps, 3 =
ipynb, 4 = save all).

The JAX package draws with cv2, which the card's machine lacks, so this
module draws in numpy: `draw_line`, `draw_polyline`, `draw_rectangle`,
`draw_circle` and `put_text` (also used by infer/demo.py::draw_overlay)
paint in place on an (H, W, 3) uint8 image, and `resize_bilinear` is
cv2.resize's INTER_LINEAR in floating point.  Lines stamp a disk of
diameter `thickness` along the segment; labels use utils/font.py's 5x7
bitmap font, not cv2's Hershey glyphs.  Views are written with
utils/png.py; only `show_all_imgs` needs cv2 (a window).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from . import font
from .png import write_frame


def color_table(n: int = 80) -> np.ndarray:
    """The reference's class colours: row j is (67 j, 131 j, 197 j) mod 255."""
    colors = []
    for j in range(n):
        colors.append(((j * 67) % 255, (j * 131) % 255, (j * 197) % 255))
    return np.array(colors, dtype=np.uint8)


# -- drawing primitives (in place, on (H, W, 3) uint8, colour in channel
#    order) --------------------------------------------------------------

def _paint(img: np.ndarray, ys: np.ndarray, xs: np.ndarray, color):
    """Set the pixels (ys, xs) that lie inside the image to `color`."""
    h, w = img.shape[:2]
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[keep], xs[keep]] = color


def _disk(radius: float):
    """(dy, dx) of the pixels within `radius` of a pixel's centre."""
    k = int(np.floor(radius))
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
    inside = dy * dy + dx * dx <= radius * radius
    return dy[inside], dx[inside]


def _segments(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, color,
              thickness: int = 1):
    """Draw the segments p0[i] -> p1[i] ((n, 2) as (x, y)): each is first
    clipped to the image grown by `thickness` (Liang-Barsky), then sampled
    once a pixel along its longer axis and rounded, and a disk of
    diameter `thickness` is stamped at each sample."""
    h, w = img.shape[:2]
    p0 = np.asarray(p0, np.float64).reshape(-1, 2)
    p1 = np.asarray(p1, np.float64).reshape(-1, 2)
    d = p1 - p0
    m = float(thickness)
    lo, hi = np.zeros(len(d)), np.ones(len(d))
    ok = np.ones(len(d), bool)
    for p, q in ((-d[:, 0], p0[:, 0] + m), (d[:, 0], w - 1 + m - p0[:, 0]),
                 (-d[:, 1], p0[:, 1] + m), (d[:, 1], h - 1 + m - p0[:, 1])):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = q / p
        ok &= ~((p == 0) & (q < 0))
        lo = np.where(p < 0, np.maximum(lo, t), lo)
        hi = np.where(p > 0, np.minimum(hi, t), hi)
    ok &= lo <= hi
    a, b = p0[ok] + lo[ok, None] * d[ok], p0[ok] + hi[ok, None] * d[ok]
    if not len(a):
        return
    n = np.ceil(np.abs(b - a).max(axis=1)).astype(np.int64) + 1
    seg = np.repeat(np.arange(len(n)), n)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    t = k / np.maximum(n[seg] - 1, 1)
    pts = np.rint(a[seg] + t[:, None] * (b - a)[seg]).astype(np.int64)
    if thickness > 1:
        dy, dx = _disk(thickness / 2.0)
        ys = (pts[:, 1, None] + dy).ravel()
        xs = (pts[:, 0, None] + dx).ravel()
    else:
        ys, xs = pts[:, 1], pts[:, 0]
    _paint(img, ys, xs, color)


def draw_line(img: np.ndarray, pt0, pt1, color, thickness: int = 1):
    """cv2.line: pt0 -> pt1 as (x, y)."""
    _segments(img, [pt0], [pt1], color, thickness)


def draw_polyline(img: np.ndarray, pts, color, thickness: int = 1,
                  closed: bool = True):
    """cv2.polylines of one (n, 2) (x, y) point list."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    if not len(pts):
        return
    if len(pts) == 1:
        _segments(img, pts, pts, color, thickness)
        return
    ends = np.roll(pts, -1, axis=0) if closed else pts[1:]
    _segments(img, pts[:len(ends)], ends, color, thickness)


def draw_rectangle(img: np.ndarray, pt0, pt1, color, thickness: int = 1):
    """cv2.rectangle between the corners pt0 and pt1 (x, y), both
    included; thickness < 0 fills it."""
    (x0, y0), (x1, y1) = np.asarray(pt0, int), np.asarray(pt1, int)
    x0, x1 = sorted((int(x0), int(x1)))
    y0, y1 = sorted((int(y0), int(y1)))
    if thickness < 0:
        h, w = img.shape[:2]
        img[max(y0, 0):max(min(y1 + 1, h), 0),
            max(x0, 0):max(min(x1 + 1, w), 0)] = color
        return
    draw_polyline(img, [(x0, y0), (x1, y0), (x1, y1), (x0, y1)], color,
                  thickness)


def draw_circle(img: np.ndarray, center, radius: float, color,
                thickness: int = 1):
    """cv2.circle: the ring of pixels within thickness / 2 of `radius`
    from the centre, or with thickness < 0 the whole disk."""
    cx, cy = int(center[0]), int(center[1])
    reach = int(np.ceil(radius + max(thickness, 0) / 2.0))
    dy, dx = np.mgrid[-reach:reach + 1, -reach:reach + 1]
    dist = np.sqrt(dy * dy + dx * dx)
    on = (dist <= radius) if thickness < 0 else (
        np.abs(dist - radius) <= max(thickness, 1) / 2.0)
    _paint(img, (cy + dy[on]).ravel(), (cx + dx[on]).ravel(), color)


def text_size(text: str, scale: int = 1):
    """(width, height) of `put_text`'s label, as cv2.getTextSize's first
    item."""
    mask = font.text_mask(text, scale)
    return mask.shape[1], mask.shape[0]


def put_text(img: np.ndarray, text: str, org, color, scale: int = 1):
    """cv2.putText with utils/font.py's bitmap font: `org` (x, y) is the
    bottom-left corner of the label, its bottom row at y - 1."""
    mask = font.text_mask(text, scale)
    ys, xs = np.nonzero(mask)
    _paint(img, ys + int(org[1]) - mask.shape[0], xs + int(org[0]), color)


def resize_bilinear(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(img, (w, h)) with INTER_LINEAR on an (H, W[, C]) uint8
    image: half-pixel centres, edges clamped, blended in float and
    rounded (cv2 blends in 11-bit fixed point: at most 1 level apart)."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])

    def taps(n_in, n_out):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(f).astype(np.int64)
        frac = f - i0
        frac = np.where(i0 < 0, 0.0, frac)
        i0 = np.clip(i0, 0, n_in - 1)
        frac = np.where(i0 >= n_in - 1, 0.0, frac)
        return i0, np.minimum(i0 + 1, n_in - 1), frac.astype(np.float32)

    src = np.asarray(img).astype(np.float32)
    y0, y1, fy = taps(src.shape[0], out_h)
    x0, x1, fx = taps(src.shape[1], out_w)
    expand = (slice(None),) + (None,) * (src.ndim - 1)
    rows = src[y0] * (1 - fy[expand]) + src[y1] * fy[expand]
    expand = (None, slice(None)) + (None,) * (src.ndim - 2)
    out = rows[:, x0] * (1 - fx[expand]) + rows[:, x1] * fx[expand]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class Debugger:
    def __init__(self, num_classes: int = 8,
                 class_names: Optional[List[str]] = None,
                 down_ratio: int = 4, theme: str = "black"):
        self.imgs: Dict[str, np.ndarray] = {}
        self.num_classes = num_classes
        self.names = class_names or [str(i) for i in range(num_classes)]
        self.down_ratio = down_ratio
        self.theme = theme
        self.colors = color_table(max(num_classes, 32))

    # -- image store ------------------------------------------------------

    def add_img(self, img: np.ndarray, img_id: str = "default"):
        self.imgs[img_id] = img.copy()

    def add_mask(self, mask: np.ndarray, bg: np.ndarray,
                 img_id: str = "default", trans: float = 0.8):
        self.imgs[img_id] = (
            mask.reshape(mask.shape[0], mask.shape[1], 1) * 255 * trans
            + bg * (1 - trans)).astype(np.uint8)

    def add_blend_img(self, back: np.ndarray, fore: np.ndarray,
                      img_id: str = "blend", trans: float = 0.7):
        """Overlay a colour-mapped heat map on an image (ref :94-106)."""
        if self.theme == "white":
            fore = 255 - fore
        if fore.shape[:2] != back.shape[:2]:
            fore = resize_bilinear(fore, back.shape[:2])
        if len(fore.shape) == 2:
            fore = fore.reshape(*fore.shape, 1)
        img = back * (1.0 - trans) + fore * trans
        self.imgs[img_id] = np.clip(img, 0, 255).astype(np.uint8)

    # -- colormaps --------------------------------------------------------

    def gen_colormap(self, img: np.ndarray,
                     output_res=None) -> np.ndarray:
        """(H, W, C) class heat map -> (h*R, w*R, 3) colour render (ref
        :108-140; NHWC here instead of CHW): the largest of hm * colour
        over the classes, resized bilinearly."""
        h, w, c = img.shape
        if output_res is None:
            output_res = (h * self.down_ratio, w * self.down_ratio)
        colors = self.colors[:c].reshape(1, 1, c, 3).astype(np.float32)
        color_map = (img[..., None] * colors).max(axis=2)  # (H, W, 3)
        color_map = np.clip(color_map, 0, 255).astype(np.uint8)
        return resize_bilinear(color_map, output_res)

    def gen_colormap_hp(self, img: np.ndarray, output_res=None):
        """Joint-heat-map variant (ref :141-169)."""
        return self.gen_colormap(img, output_res)

    # -- overlays ---------------------------------------------------------

    def _color(self, cat: int):
        return [int(v) for v in self.colors[cat % len(self.colors)]]

    def _label(self, cat: int, conf: float) -> str:
        name = self.names[cat] if cat < len(self.names) else str(cat)
        return f"{name}{conf:.1f}"

    def add_coco_bbox(self, bbox, cat: int, conf: float = 1.0,
                      show_txt: bool = True, img_id: str = "default"):
        bbox = np.array(bbox, dtype=np.int32)
        cat = int(cat)
        c = self._color(cat)
        img = self.imgs[img_id]
        draw_rectangle(img, bbox[:2], bbox[2:4], c, 2)
        if show_txt:
            txt = self._label(cat, conf)
            tw, th = text_size(txt)
            draw_rectangle(img, (bbox[0], bbox[1] - th - 2),
                           (bbox[0] + tw, bbox[1] - 2), c, -1)
            put_text(img, txt, (bbox[0], bbox[1] - 2), (0, 0, 0))

    def add_polydet(self, vertices, cat: int, conf: float = 1.0,
                    show_txt: bool = True, img_id: str = "default"):
        """Polygon overlay (ref :214-234)."""
        pts = np.asarray(vertices, dtype=np.int32).reshape(-1, 2)
        cat = int(cat)
        c = self._color(cat)
        draw_polyline(self.imgs[img_id], pts, c, 2)
        if show_txt and len(pts):
            x0, y0 = int(pts[:, 0].min()), int(pts[:, 1].min())
            put_text(self.imgs[img_id], self._label(cat, conf),
                     (x0, max(0, y0 - 2)), c)

    def add_coco_hp(self, points, img_id: str = "default"):
        """17-joint skeleton overlay (ref :203-213)."""
        edges = [[0, 1], [0, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 6],
                 [5, 7], [7, 9], [6, 8], [8, 10], [5, 11], [6, 12],
                 [11, 12], [11, 13], [13, 15], [12, 14], [14, 16]]
        points = np.asarray(points, dtype=np.int32).reshape(-1, 2)
        for j in range(len(points)):
            draw_circle(self.imgs[img_id], points[j], 3, (255, 255, 255), -1)
        for e in edges:
            if e[0] < len(points) and e[1] < len(points):
                draw_line(self.imgs[img_id], points[e[0]], points[e[1]],
                          (255, 0, 255), 2)

    def add_points(self, points, img_id: str = "default"):
        for pt in np.asarray(points).reshape(-1, 2):
            draw_circle(self.imgs[img_id], (int(pt[0]), int(pt[1])), 3,
                        (0, 255, 255), -1)

    # -- output -----------------------------------------------------------

    def show_all_imgs(self, pause: bool = False):
        """Every view in a cv2 window (needs cv2, imported only here)."""
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("show_all_imgs opens cv2 windows and needs "
                               "cv2, which is not installed") from e
        for i, v in self.imgs.items():
            cv2.imshow(f"{i}", v)
        cv2.waitKey(0 if pause else 1)

    def save_img(self, img_id: str = "default", path: str = "./debug/"):
        os.makedirs(path, exist_ok=True)
        write_frame(os.path.join(path, f"{img_id}.png"), self.imgs[img_id])

    def save_all_imgs(self, path: str = "./debug/", prefix: str = ""):
        os.makedirs(path, exist_ok=True)
        for i, v in self.imgs.items():
            write_frame(os.path.join(path, f"{prefix}{i}.png"), v)


def debug_polydet_batch(debugger: Debugger, image: np.ndarray,
                        hm_pred: np.ndarray, hm_gt: Optional[np.ndarray],
                        dets, gt_dets=None, center_thresh: float = 0.3):
    """Compose the polydet debug views (ref trains/polydet.py:182-218):
    pred/gt heat-map blends + out_pred/out_gt polygon overlays.

    image: uint8 HWC; hm_*: (h, w, C) prob maps at output stride;
    dets rows [x0,y0,x1,y1,score,cls,poly...,depth] at output scale.
    """
    pred_cm = debugger.gen_colormap(hm_pred)
    debugger.add_blend_img(image, pred_cm, "pred_hm")
    if hm_gt is not None:
        gt_cm = debugger.gen_colormap(hm_gt)
        debugger.add_blend_img(image, gt_cm, "gt_hm")
    debugger.add_img(image, img_id="out_pred")
    r = debugger.down_ratio
    for det in np.asarray(dets):
        if det[4] > center_thresh:
            debugger.add_polydet(np.asarray(det[6:-1]) * r, int(det[5]),
                                 det[4], img_id="out_pred")
    if gt_dets is not None:
        debugger.add_img(image, img_id="out_gt")
        for det in np.asarray(gt_dets):
            if det[4] > center_thresh:
                debugger.add_coco_bbox(np.asarray(det[:4]) * r,
                                       int(det[5]), det[4],
                                       img_id="out_gt")
    return debugger
