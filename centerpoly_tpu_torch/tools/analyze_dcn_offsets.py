"""Measure learned DCN offset magnitudes to pick the band R of a bounded
DCN mode.

The bounded modes clamp offsets to [-R, R]: `halo:R` on both axes,
`rowband:R` on y only (x exact).  Whether an R is lossless for a trained
model is an empirical question about that model's offset-conv outputs.
This tool answers it: it runs the model once on a frame, collects the raw
offsets of every DCNv2 node with forward hooks on its `conv_offset_mask`,
and prints per-node |offset| percentiles and the share of offsets that an
R-clamp would saturate, one JSON row a node, then a summary whose
`lossless_halo` / `lossless_rowband` say whether the clamp is exact on
this model and frame (the JAX package's tools/analyze_dcn_offsets.py).

    python -m centerpoly_tpu_torch.tools.analyze_dcn_offsets polydet \\
        --arch dla_34 --load_model model.pth --demo frame.npy [--r 4] \\
        [--device cpu]

`--demo` takes an HWC uint8 RGB `.npy` frame, or an image file that
utils/png.py::read_image reads (PNG in numpy, other formats with cv2).  With no `--demo`, a fixed random frame is used
(meaningful only for a loaded checkpoint: a fresh init has zero offsets).
Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Mapping

import numpy as np
import torch

from ..utils.png import read_image


def offset_stats(offsets: Mapping[str, np.ndarray], r: float) -> list:
    """{node: raw offsets (B, H, W, 18), (dy, dx) interleaved} -> one stat
    row a node."""
    rows = []
    for name, raw in offsets.items():
        off = np.abs(np.asarray(raw, np.float32))
        oy = off[..., 0::2].ravel()
        ox = off[..., 1::2].ravel()
        rows.append({
            "node": name,
            "shape": list(off.shape),
            "y_p50": round(float(np.percentile(oy, 50)), 3),
            "y_p99": round(float(np.percentile(oy, 99)), 3),
            "y_p999": round(float(np.percentile(oy, 99.9)), 3),
            "y_max": round(float(oy.max()), 3),
            "x_p99": round(float(np.percentile(ox, 99)), 3),
            "x_max": round(float(ox.max()), 3),
            "y_frac_clamped_at_r": round(float((oy > r).mean()), 6),
            "xy_frac_clamped_at_r": round(float((off > r).mean()), 6),
        })
    return rows


@torch.no_grad()
def collect(cfg, variables=None, image=None, device=None
            ) -> Dict[str, np.ndarray]:
    """Run the detector's model once on `image` (HWC uint8; a seeded
    random frame of the input size when None) and return the raw offsets
    of every DCNv2 node by module name, NHWC f32 on the host."""
    from ..infer.detector import create_detector
    from ..models.deform_conv import DCNv2

    det = create_detector(cfg, variables, device=device)
    if image is None:
        image = (np.random.RandomState(0).rand(
            cfg.input_h, cfg.input_w, 3) * 255).astype(np.uint8)
    trans, meta = det._scaled_trans(*image.shape[:2], 1.0)
    frame = torch.from_numpy(np.ascontiguousarray(image)).to(det.device)[None]
    images = det._pre_device(frame, trans, (meta["inp_h"], meta["inp_w"]))

    found: Dict[str, torch.Tensor] = {}

    def hook(name):
        def save(mod, inp, out):
            found[name] = out[:, :18].permute(0, 2, 3, 1).float()
        return save

    handles = [m.conv_offset_mask.register_forward_hook(hook(name))
               for name, m in det.model.named_modules()
               if isinstance(m, DCNv2)]
    if not handles:
        raise ValueError(f"arch {cfg.arch!r} has no DCNv2 node: there are no "
                         f"offsets to measure")
    try:
        det.model(images)
    finally:
        for h in handles:
            h.remove()
    return {k: v.cpu().numpy() for k, v in found.items()}


def read_frame(path: str) -> np.ndarray:
    """HWC uint8 RGB frame from a `.npy` file as it is, or from an image
    file through utils/png.py::read_image (BGR, flipped)."""
    if path.endswith(".npy"):
        return np.load(path)
    return np.ascontiguousarray(read_image(path)[:, :, ::-1])


def main(argv=None) -> list:
    from ..configs import Config
    from ..infer.demo import _pop_opt

    argv = list(sys.argv[1:] if argv is None else argv)
    demo = _pop_opt(argv, "--demo")
    r = float(_pop_opt(argv, "--r") or 4.0)
    device = _pop_opt(argv, "--device")
    cfg = Config.from_args(argv)

    image = read_frame(demo) if demo else None
    try:
        offsets = collect(cfg, image=image, device=device)
    except ValueError as e:
        raise SystemExit(f"analyze_dcn_offsets: {e}") from e
    rows = offset_stats(offsets, r)
    worst_y = 0.0   # rowband clamps y only
    worst_xy = 0.0  # halo clamps both axes
    for row in rows:
        row["r"] = r
        worst_y = max(worst_y, row["y_frac_clamped_at_r"])
        worst_xy = max(worst_xy, row["xy_frac_clamped_at_r"])
        print(json.dumps(row))
    print(json.dumps({
        "summary": "offset clamp saturation across nodes at R",
        "r": r,
        "worst_node_frac_y": worst_y,
        "worst_node_frac_xy": worst_xy,
        "lossless_rowband": worst_y == 0.0,
        "lossless_halo": worst_xy == 0.0,
    }))
    return rows


if __name__ == "__main__":
    main()
