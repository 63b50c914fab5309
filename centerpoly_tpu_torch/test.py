"""Batch evaluation entry (reference surface: src/test.py, prefetch_test;
the JAX package's test.py):

    python -m centerpoly_tpu_torch.test polydet --dataset cityscapes \
        --data_dir <root> [--load_model model_best.pth] [--eval_batch B] \
        [--device cpu]

Runs the detector over the val split on the card (`--device cpu` runs the
port on the CPU), with per-stage time averages for `--eval_batch 1` and a
prefetch thread feeding `run_batch` for larger batches; then the dataset's
instance-AP eval: results.json, mask PNGs and txt manifests, and
instance_ap.json and gtInstances.json under <save_dir>/<dataset>/<task>/
<exp_id>.  The GT is found by the frames' Cityscapes names
(<stem>_leftImg8bit.png -> <stem>_gtFine_instanceIds.png), so frames stored
under other names (`.npy`) cannot be scored.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time

STAGES = ("tot", "load", "pre", "net", "dec", "post", "merge")


def _run_single(detector, sampler) -> dict:
    """`run` frame by frame, printing the stage averages every 50 frames."""
    results, sums = {}, dict.fromkeys(STAGES, 0.0)
    for idx, img_id in enumerate(sampler.images):
        ret = detector.run(sampler._load_image(img_id))
        results[img_id] = ret["results"]
        for s in STAGES:
            sums[s] += ret[s]
        if idx % 50 == 0 or idx == len(sampler) - 1:
            line = "|".join(f"{s} {sums[s] / (idx + 1):.3f}s" for s in STAGES)
            print(f"[{idx}/{len(sampler)}] {line}")
    return results


def _run_batched(detector, sampler, bs: int) -> dict:
    """`run_batch` over groups of up to `bs` same-shaped frames, fed by a
    prefetch thread; a shape change or a full group flushes."""
    q: queue.Queue = queue.Queue(maxsize=2 * bs)
    done = object()

    def produce():
        try:
            for img_id in sampler.images:
                q.put((img_id, sampler._load_image(img_id)))
            q.put(done)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            q.put(e)

    threading.Thread(target=produce, daemon=True).start()
    results, group, done_n = {}, [], 0
    t0 = time.perf_counter()

    def flush():
        outs = detector.run_batch([g[1] for g in group])
        for (img_id, _), out in zip(group, outs):
            results[img_id] = out["results"]

    while True:
        item = q.get()
        if isinstance(item, BaseException):
            raise item
        if item is done:
            if group:
                flush()
            break
        if group and (len(group) == bs or item[1].shape != group[0][1].shape):
            flush()
            done_n += len(group)
            group = []
            if done_n % (10 * bs) < bs:
                print(f"[{done_n}/{len(sampler)}] "
                      f"{done_n / (time.perf_counter() - t0):.2f} img/s (wall)")
        group.append(item)
    return results


def setup(argv: list, device=None) -> tuple:
    """(cfg, meta, val annotations, val sampler, detector) from test.py's
    arguments (without `--device`)."""
    from .configs import Config
    from .data import DATASETS, SAMPLERS, CocoPolyAnnotations
    from .infer.detector import create_detector

    cfg = Config.from_args(argv)
    if cfg.prefer_fast_inference_dcn():
        print(f"[centerpoly] inference defaulting to dcn_kernel="
              f"{cfg.dcn_kernel} (y-offsets banded; pass --dcn_kernel off "
              f"for exact DCNv2 semantics)", file=sys.stderr)
    meta_cls = DATASETS.get(cfg.dataset)
    if meta_cls is None:
        raise SystemExit(f"dataset '{cfg.dataset}' has no adapter")
    meta = meta_cls(cfg.data_dir, cfg.nbr_points)
    sampler_cls = SAMPLERS.get(cfg.task)
    if sampler_cls is None:
        raise SystemExit(f"task '{cfg.task}' has no sampler")
    split = "val"
    ann = CocoPolyAnnotations(meta.annot_path(split))
    sampler = sampler_cls(cfg, meta, ann, split=split,
                          img_dir=meta.img_dir(split))
    return cfg, meta, ann, sampler, create_detector(cfg, device=device)


def main(argv=None, device=None) -> dict:
    """Returns {"ap": the evaluator's dict or None, "results" (per image
    id), "frames", "seconds" (of the detector loop), "eval_seconds" (of
    run_eval), "save_dir"}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    cfg, meta, ann, sampler, detector = setup(argv, device)

    t0 = time.perf_counter()
    bs = max(1, cfg.eval_batch)
    results = (_run_batched(detector, sampler, bs) if bs > 1
               else _run_single(detector, sampler))
    seconds = time.perf_counter() - t0
    print(f"{len(results)} frames in {seconds:.3f} s "
          f"({len(results) / seconds:.3f} frames/s, eval_batch {bs}, "
          f"{detector.device})")

    save_dir = os.path.join(cfg.save_dir, cfg.dataset, cfg.task, cfg.exp_id)
    os.makedirs(save_dir, exist_ok=True)
    t0 = time.perf_counter()
    ap = meta.run_eval(results, save_dir, annotations=ann, thresh=cfg.thresh)
    eval_seconds = time.perf_counter() - t0
    if ap is not None:
        print("instance AP:", ap.get("allAp"), "AP50:", ap.get("allAp50%"))
    else:
        print("results written to", save_dir,
              "(no GT instance images available for AP)")
    return {"ap": ap, "results": results, "frames": len(results),
            "seconds": seconds,
            "eval_seconds": eval_seconds, "save_dir": save_dir}


if __name__ == "__main__":
    main()
