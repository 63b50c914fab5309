"""The serving pipeline of a polydet detector in plain PyTorch and numpy:
the crop/resize affine (CenterPoly utils/image.py:27-92), the bilinear
input warp with normalisation, the heads, and the decode of every output
pixel into a detection in frame coordinates (decode.py:512-670,
post_process.py:105-122): sigmoid score per class, box, 16-vertex polygon
and depth.  A peak is a pixel equal to its 3x3 max (`peak_scores`)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _third_point(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def affine_transform(center, scale: float, output_size,
                     inv: bool = False) -> np.ndarray:
    """2x3 matrix mapping the square window of side `scale` centred at
    `center` onto the (w, h) canvas `output_size` (no rotation, no
    shift), or its inverse."""
    center = np.asarray(center, np.float32)
    dst_w, dst_h = output_size
    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + np.array([0, scale * -0.5], np.float32)
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + np.array(
        [0, dst_w * -0.5], np.float32)
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])
    a, b = (dst, src) if inv else (src, dst)
    m = np.linalg.solve(np.concatenate([a.astype(np.float64),
                                        np.ones((3, 1))], 1),
                        b.astype(np.float64))
    return m.T


def frame_geometry(frame_h: int, frame_w: int, inp_h: int, inp_w: int,
                   down: int):
    """(input warp matrix, output->frame matrix) of a fixed-resolution
    detector: the frame centred, scaled by its longer side."""
    c = np.array([frame_w / 2.0, frame_h / 2.0], np.float32)
    s = float(max(frame_h, frame_w))
    return (affine_transform(c, s, (inp_w, inp_h)),
            affine_transform(c, s, (inp_w // down, inp_h // down), inv=True))


def _sampling(out_size: int, in_size: int, scale: float, shift: float,
              device) -> torch.Tensor:
    o = torch.arange(out_size, dtype=torch.float64, device=device)
    src = (o - shift) / scale
    i = torch.arange(in_size, dtype=torch.float64, device=device)
    return (1.0 - (src[:, None] - i[None, :]).abs()).clamp_min(0.0)


def preprocess(frames_u8: torch.Tensor, trans: np.ndarray, inp_h: int,
               inp_w: int, mean, std) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalised f32 (B, 3, inp_h, inp_w): the
    axis-aligned bilinear warp (zero outside the frame) in f64, then
    (x / 255 - mean) / std."""
    dev = frames_u8.device
    b, h, w, _ = frames_u8.shape
    wy = _sampling(inp_h, h, trans[1, 1], trans[1, 2], dev)
    wx = _sampling(inp_w, w, trans[0, 0], trans[0, 2], dev)
    img = frames_u8.double()
    x = torch.einsum("yh,bhwc,xw->bcyx", wy, img, wx)
    mean = torch.tensor(mean, dtype=torch.float64, device=dev)
    std = torch.tensor(std, dtype=torch.float64, device=dev)
    x = (x / 255.0 - mean[:, None, None]) / std[:, None, None]
    return x.float()


def pixel_detections(heads, to_frame: np.ndarray):
    """Every output pixel decoded as a polydet detection (polar rep, with
    the sub-pixel offset): (scores (B, C, H*W), coords (B, H*W, 36) =
    [x0, y0, x1, y1, x_0, y_0, ..., x_15, y_15] in frame pixels, depth
    (B, H*W))."""
    hm = torch.sigmoid(heads["hm"].float())
    b, c, h, w = hm.shape
    poly = heads["poly"].float().permute(0, 2, 3, 1).reshape(b, h * w, -1)
    reg = heads["reg"].float().permute(0, 2, 3, 1).reshape(b, h * w, 2)
    depth = heads["pseudo_depth"].float().reshape(b, h * w)
    ys, xs = torch.meshgrid(torch.arange(h, device=hm.device),
                            torch.arange(w, device=hm.device), indexing="ij")
    cx = xs.reshape(-1).float() + reg[..., 0]
    cy = ys.reshape(-1).float() + reg[..., 1]
    r, theta = poly[..., 0::2], poly[..., 1::2]
    px = r * torch.cos(theta) + cx[..., None]
    py = r * torch.sin(theta) + cy[..., None]
    t = torch.as_tensor(to_frame, dtype=torch.float32, device=hm.device)
    fx = px * t[0, 0] + py * t[0, 1] + t[0, 2]
    fy = px * t[1, 0] + py * t[1, 1] + t[1, 2]
    box = torch.stack([fx.amin(-1), fy.amin(-1), fx.amax(-1), fy.amax(-1)],
                      -1)
    pts = torch.stack([fx, fy], -1).reshape(b, h * w, -1)
    return hm.reshape(b, c, h * w), torch.cat([box, pts], -1), depth


def peak_scores(heads) -> torch.Tensor:
    """(B, C, H*W) scores at the peaks, 0 elsewhere: a peak is a pixel
    equal to its 3x3 max in its class's map."""
    hm = torch.sigmoid(heads["hm"].float())
    hmax = F.max_pool2d(hm, 3, stride=1, padding=1)
    return torch.where(hmax == hm, hm, 0.0).flatten(2)


def served_results(heads, to_frame: np.ndarray, k: int):
    """The K best peaks of each frame over classes and positions, as a
    detector serves them: [{"results": {class id: rows [x0, y0, x1, y1,
    score, poly 32, depth]}}] in frame coordinates."""
    scores, coords, depth = pixel_detections(heads, to_frame)
    peaks = peak_scores(heads)
    b, c = peaks.shape[:2]
    val, flat = torch.topk(peaks.reshape(b, -1), k)
    cls, pix = flat // scores.shape[-1], flat % scores.shape[-1]
    out = []
    for i in range(b):
        rows = torch.cat([coords[i, pix[i], :4], val[i, :, None],
                          coords[i, pix[i], 4:], depth[i, pix[i], None]],
                         1).cpu().numpy()
        ci = cls[i].cpu().numpy()
        out.append({"results": {j + 1: rows[ci == j] for j in range(c)}})
    return out
