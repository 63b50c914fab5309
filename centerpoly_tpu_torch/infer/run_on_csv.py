"""Run the detector over every image listed in a CSV and write a
detection CSV (reference surface: src/run_on_csv.py; the JAX package's
infer/run_on_csv.py).

    python -m centerpoly_tpu_torch.infer.run_on_csv polydet \
        --source_csv in.csv --target_csv out.csv \
        --arch smallhourglass --load_model model.pth --dataset cityscapes \
        [--eval_batch 4] [--infer_devices 2] [--device cpu]

Input CSV rows start with the image path (first column); the paths are
sorted and de-duplicated.  Output rows are `path,x0,y0,x1,y1,label,score,
x1,y1,...` as the reference writes them (run_on_csv.py:69-76).  Images
are read with utils/png.py::read_image (PNG and .npy without cv2).  With
--eval_batch B, consecutive frames of one shape go through one
`run_batch` of up to B (a change of shape flushes the batch);
--infer_devices N serves each batch over one replica on each of the first
N cards.  Runs on the card; `--device cpu` runs the port on the CPU.
"""
from __future__ import annotations

import sys

from ..utils.png import read_image


def csv_rows(path: str, results, num_classes: int, class_names) -> list:
    """One detection row a result, as the reference emits them: the box
    and polygon truncated to int, the score as Python prints it."""
    rows = []
    for label in range(1, num_classes + 1):
        for det in results[label]:
            box = [int(v) for v in det[:4]]
            poly = [int(v) for v in det[5:-1]] if len(det) > 6 else []
            row = [path] + box + [class_names[label - 1], float(det[4])] + poly
            rows.append(",".join(str(v) for v in row))
    return rows


def serve_csv(detector, images, target_csv: str, batch: int,
              class_names) -> int:
    """Run `detector` over the image paths in order and write their rows
    to `target_csv`: consecutive frames of one shape go through one
    `run_batch` of up to `batch`, a change of shape flushing it; an
    unreadable image is skipped.  Returns the number of frames served."""
    num_classes = detector.num_classes
    n, served = len(images), 0
    with open(target_csv, "w") as out:
        pend_paths, pend_imgs = [], []

        def flush():
            if pend_paths:
                for pth, ret in zip(pend_paths,
                                    detector.run_batch(pend_imgs)):
                    for row in csv_rows(pth, ret["results"], num_classes,
                                        class_names):
                        out.write(row + "\n")
            pend_paths.clear()
            pend_imgs.clear()

        for count, path in enumerate(images):
            if count % 100 == 0:
                print(f"progress: {100.0 * count / max(n, 1):.1f}%",
                      flush=True)
            try:
                img = read_image(path)
            except ValueError:
                print(f"skipping unreadable {path}")
                continue
            if pend_imgs and img.shape != pend_imgs[0].shape:
                flush()
            pend_paths.append(path)
            pend_imgs.append(img)
            served += 1
            if len(pend_paths) >= batch:
                flush()
        flush()
    return served


def main(argv=None):
    from ..configs import Config
    from ..data import DATASETS
    from ..train.mesh import serving_devices
    from .demo import _pop_opt
    from .detector import create_detector

    argv = list(sys.argv[1:] if argv is None else argv)
    source_csv = _pop_opt(argv, "--source_csv")
    target_csv = _pop_opt(argv, "--target_csv", "results.csv")
    device = _pop_opt(argv, "--device")
    if source_csv is None:
        raise SystemExit("--source_csv <csv> is required")

    cfg = Config.from_args(argv)
    if cfg.prefer_fast_inference_dcn():
        print(f"[centerpoly] inference defaulting to dcn_kernel="
              f"{cfg.dcn_kernel} (y-offsets banded; pass --dcn_kernel off "
              f"for exact DCNv2 semantics)", file=sys.stderr)
    meta_cls = DATASETS.get(cfg.dataset)
    class_names = (meta_cls.class_name[1:] if meta_cls
                   else [str(i) for i in range(cfg.num_classes)])
    devices = (serving_devices(cfg.infer_devices, device or "cuda")
               if cfg.infer_devices > 1 else None)
    detector = create_detector(cfg, device=device, devices=devices)
    with open(source_csv) as f:
        images = sorted({line.split(",")[0].strip() for line in f
                         if line.strip()})
    serve_csv(detector, images, target_csv, max(1, cfg.eval_batch),
              class_names)
    print(f"wrote {target_csv}")


if __name__ == "__main__":
    main()
