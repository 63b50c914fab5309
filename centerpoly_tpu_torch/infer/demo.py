"""Single-image / folder inference CLI (reference surface: src/demo.py).

    python -m centerpoly_tpu_torch.infer.demo polydet --demo path/to/img.png \
        --arch dla_34 --load_model model_best.pth [--save_overlay]

Prints the reference's per-stage timing line (demo.py:50-53) for each
image; --save_overlay writes an overlay next to each input.  Runs on the
card; `--device cpu` runs the port on the CPU instead.
"""
from __future__ import annotations

import os
import sys

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".ppm")
TIME_STATS = ("tot", "load", "pre", "net", "dec", "post", "merge")


def draw_overlay(image: np.ndarray, results, vis_thresh: float = 0.3):
    """OpenCV polygon overlay (reference debugger.add_polydet,
    src/lib/utils/debugger.py:214-234)."""
    import cv2

    out = image.copy()
    colors = [(np.array([((j * 67) % 255), ((j * 131) % 255),
                         ((j * 197) % 255)])).tolist()
              for j in range(32)]
    for cls_id, rows in results.items():
        for row in rows:
            if row[4] > vis_thresh:
                poly = np.asarray(row[5:-1]).reshape(-1, 2).astype(np.int32)
                cv2.polylines(out, [poly], True, colors[int(cls_id) % 32], 2)
                x0, y0 = int(row[0]), int(row[1])
                cv2.putText(out, f"{row[4]:.2f}", (x0, max(0, y0 - 3)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                            colors[int(cls_id) % 32], 1)
    return out


def _timing_line(ret) -> str:
    return "".join(f"{s} {ret[s]:.3f}s |" for s in TIME_STATS)


def _pop_flag(argv, name):
    if name in argv:
        argv.remove(name)
        return True
    return False


def _pop_opt(argv, name, default=None):
    if name in argv:
        i = argv.index(name)
        val = argv[i + 1]
        del argv[i:i + 2]
        return val
    return default


def main(argv=None):
    from ..configs import Config
    from .detector import create_detector

    argv = list(sys.argv[1:] if argv is None else argv)
    save_overlay = _pop_flag(argv, "--save_overlay")
    demo_path = _pop_opt(argv, "--demo")
    device = _pop_opt(argv, "--device")
    cfg = Config.from_args(argv)
    if cfg.prefer_fast_inference_dcn():
        print(f"[centerpoly] inference defaulting to dcn_kernel="
              f"{cfg.dcn_kernel} (y-offsets banded; pass --dcn_kernel off "
              f"for exact DCNv2 semantics)", file=sys.stderr)
    if demo_path is None:
        raise SystemExit("--demo <image|folder> is required")
    ext = os.path.splitext(demo_path)[1].lower()
    if demo_path == "webcam" or (ext and ext not in IMG_EXTS):
        raise SystemExit("video and webcam input are not ported yet "
                         "(ROADMAP.md queue A)")

    detector = create_detector(cfg, device=device)
    if os.path.isdir(demo_path):
        files = [os.path.join(demo_path, f)
                 for f in sorted(os.listdir(demo_path))
                 if f.lower().endswith(IMG_EXTS)]
    else:
        files = [demo_path]

    import cv2
    for path in files:
        img = cv2.imread(path)
        if img is None:
            print(f"skipping unreadable {path}")
            continue
        ret = detector.run(img)
        print(f"{os.path.basename(path)}: {_timing_line(ret)}")
        if save_overlay:
            out = draw_overlay(img, ret["results"], cfg.vis_thresh)
            out_path = os.path.splitext(path)[0] + "_polydet.png"
            cv2.imwrite(out_path, out)
            print(f"  overlay -> {out_path}")


if __name__ == "__main__":
    main()
