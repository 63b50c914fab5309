"""Single-image / folder / video / webcam inference CLI (reference
surface: src/demo.py; the JAX package's infer/demo.py).

    python -m centerpoly_tpu_torch.infer.demo polydet --demo path/to/img.png \
        --arch dla_34 --load_model model_best.pth [--save_overlay]
    python -m centerpoly_tpu_torch.infer.demo polydet --demo clip.mp4 \
        --out_video clip_polydet.avi --max_frames 100 [--eval_batch 4 | --stream]
    python -m centerpoly_tpu_torch.infer.demo polydet --demo webcam --show

Prints the reference's per-stage timing line (demo.py:50-53) for each
image or frame.  For images, --save_overlay writes an overlay PNG next to
each input; --debug N / --debug_dir D compose the detector's debug views
(level 4 saves them).  Images are read with utils/png.py::read_image
(PNG and .npy in numpy) and overlays drawn and written without cv2.
Video and webcam input (demo.py:23-36) needs cv2 to decode frames, to
write --out_video and to --show: it is imported only there, and the CLI
exits naming it where it is missing.  Runs on the card; `--device cpu`
runs the port on the CPU instead.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..utils.debugger import color_table, draw_polyline, put_text
from ..utils.png import read_image, write_frame

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".ppm")
VIDEO_EXTS = (".mp4", ".mov", ".avi", ".mkv")
TIME_STATS = ("tot", "load", "pre", "net", "dec", "post", "merge")
_COLORS = color_table(32).tolist()


def draw_overlay(image: np.ndarray, results, vis_thresh: float = 0.3):
    """Polygon overlay (reference debugger.add_polydet,
    src/lib/utils/debugger.py:214-234), drawn in numpy."""
    out = np.ascontiguousarray(image).copy()
    for cls_id, rows in results.items():
        color = _COLORS[int(cls_id) % 32]
        for row in rows:
            if row[4] > vis_thresh:
                poly = np.asarray(row[5:-1]).reshape(-1, 2).astype(np.int32)
                draw_polyline(out, poly, color, 2)
                x0, y0 = int(row[0]), int(row[1])
                put_text(out, f"{row[4]:.2f}", (x0, max(0, y0 - 3)), color)
    return out


def _timing_line(ret) -> str:
    return "".join(f"{s} {ret[s]:.3f}s |" for s in TIME_STATS)


def _cv2(what: str):
    try:
        import cv2
    except ImportError:
        raise SystemExit(f"{what} needs cv2 (OpenCV), which is not "
                         f"installed") from None
    return cv2


def open_video(source: str):
    """A cv2.VideoCapture of `source` ("webcam" is device 0)."""
    cv2 = _cv2("video and webcam input")
    cam = cv2.VideoCapture(0 if source == "webcam" else source)
    if not cam.isOpened():
        raise SystemExit(f"cannot open video source {source!r}")
    return cam


class MemoryCapture:
    """cv2.VideoCapture's read / get / release over frames already in
    memory (HWC uint8 BGR), for `video_results` and `run_video` where no
    cv2 decodes a file."""

    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        return (True, self.frames.pop(0)) if self.frames else (False, None)

    def get(self, prop):
        return 0.0

    def release(self):
        self.frames = []


def video_results(detector, cam, batch: int = 1, stream: bool = False,
                  max_frames: int = 0):
    """The video loops of the reference demo.py:23-36: read frames from
    `cam` (anything with cv2.VideoCapture's read() and release()) until it
    ends or after `max_frames` (> 0), and yield (frame, result) in frame
    order; `cam` is released when the generator ends or is closed.

    batch > 1 groups frames through `run_batch` (one forward a stack: an
    offline transcode); stream=True pipelines single frames through
    `run_stream` (frame i+1 dispatched while frame i runs: a live feed's
    latency); else each frame goes through `run`.  A result holds
    "results", and "rate" (frames/s of wall time so far) in the batched
    and pipelined loops, or `run`'s stage times."""
    def frames():
        served = 0
        while not (max_frames and served >= max_frames):
            ok, img = cam.read()
            if not ok or img is None:
                return
            yield img
            served += 1

    t0 = time.perf_counter()
    n = 0
    try:
        if batch > 1:
            buf = []
            for img in frames():
                buf.append(img)
                if len(buf) == batch:
                    yield from _flush(detector, buf, t0, n)
                    n += len(buf)
                    buf = []
            if buf:
                yield from _flush(detector, buf, t0, n)
        elif stream:
            seen = []

            def tee(src):
                for img in src:
                    seen.append(img)
                    yield img

            for results in detector.run_stream(tee(frames())):
                n += 1
                yield seen.pop(0), {"results": results,
                                    "rate": n / (time.perf_counter() - t0)}
        else:
            for img in frames():
                yield img, detector.run(img)
    finally:
        cam.release()


def _flush(detector, buf, t0, n):
    """Yield one run_batch's frames and results in order."""
    outs = detector.run_batch(buf)
    rate = (n + len(buf)) / (time.perf_counter() - t0)
    for img, out in zip(buf, outs):
        yield img, {"results": out["results"], "rate": rate}


def _video_writer(path: str, cam, size):
    """An MJPG writer at `cam`'s frame rate (30 where it reports none)."""
    cv2 = _cv2("--out_video")
    return cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"),
                           cam.get(cv2.CAP_PROP_FPS) or 30.0, size)


def run_video(detector, cam, vis_thresh: float = 0.3,
              out_video: str | None = None, max_frames: int = 0,
              show: bool = False, batch: int = 1,
              stream: bool = False) -> int:
    """Drive `video_results` over `cam` (see `open_video`), print a line a
    frame, write the overlays to `out_video` (MJPG; cv2) and, with `show`,
    show them in a cv2 window (esc quits; the loop is then per frame).
    Returns the number of frames processed."""
    if show:
        batch, stream = 1, False
    kind = ("(wall)" if batch > 1
            else "(wall, pipelined)" if stream else None)
    writer = None
    n = 0
    loop = video_results(detector, cam, batch, stream, max_frames)
    try:
        for img, ret in loop:
            print(f"frame {n}: " + (_timing_line(ret) if kind is None else
                                    f"{ret['rate']:.2f} img/s {kind}"))
            n += 1
            if out_video is None and not show:
                continue
            overlay = draw_overlay(img, ret["results"], vis_thresh)
            if out_video is not None:
                if writer is None:
                    h, w = overlay.shape[:2]
                    writer = _video_writer(out_video, cam, (w, h))
                writer.write(overlay)
            if show:
                cv2 = _cv2("--show")
                cv2.imshow("input", img)
                cv2.imshow("polydet", overlay)
                if cv2.waitKey(1) == 27:  # esc to quit (ref demo.py:35)
                    break
    finally:
        loop.close()
        if writer is not None:
            writer.release()
    if out_video is not None:
        print(f"annotated video -> {out_video} ({n} frames)")
    return n


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
    show = _pop_flag(argv, "--show")
    out_video = _pop_opt(argv, "--out_video")
    stream = _pop_flag(argv, "--stream")
    max_frames = int(_pop_opt(argv, "--max_frames", 0))
    demo_path = _pop_opt(argv, "--demo")
    device = _pop_opt(argv, "--device")
    cfg = Config.from_args(argv)
    if cfg.prefer_fast_inference_dcn():
        print(f"[centerpoly] inference defaulting to dcn_kernel="
              f"{cfg.dcn_kernel} (y-offsets banded; pass --dcn_kernel off "
              f"for exact DCNv2 semantics)", file=sys.stderr)
    if demo_path is None:
        raise SystemExit("--demo <image|folder|video|webcam> is required")
    video = (demo_path == "webcam"
             or os.path.splitext(demo_path)[1].lower() in VIDEO_EXTS)
    if video and stream and show:
        raise SystemExit("--stream is headless-only (pipelining has no "
                         "frame to show until depth frames later); drop "
                         "--show or --stream")
    if video and stream and cfg.eval_batch > 1:
        raise SystemExit("--stream and --eval_batch>1 are different serving "
                         "modes (pipelined single-frame vs batched "
                         "transcode); pick one")

    cam = open_video(demo_path) if video else None
    detector = create_detector(cfg, device=device)
    if video:
        run_video(detector, cam, cfg.vis_thresh,
                  out_video=out_video, max_frames=max_frames, show=show,
                  batch=max(1, cfg.eval_batch), stream=stream)
        return
    if os.path.isdir(demo_path):
        files = [os.path.join(demo_path, f)
                 for f in sorted(os.listdir(demo_path))
                 if f.lower().endswith(IMG_EXTS)]
    else:
        files = [demo_path]

    for path in files:
        try:
            img = read_image(path)
        except ValueError:
            print(f"skipping unreadable {path}")
            continue
        ret = detector.run(img)
        print(f"{os.path.basename(path)}: {_timing_line(ret)}")
        if save_overlay:
            out = draw_overlay(img, ret["results"], cfg.vis_thresh)
            out_path = os.path.splitext(path)[0] + "_polydet.png"
            write_frame(out_path, out)
            print(f"  overlay -> {out_path}")


if __name__ == "__main__":
    main()
