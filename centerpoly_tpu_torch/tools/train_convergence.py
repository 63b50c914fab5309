"""Oracle-free end-to-end training convergence (the JAX package's
experiments/train_convergence.py).

Overfits the real polydet train step on a synthetic rectangle fixture and
scores *predicted* (no oracle substitution) decode -> rasterize ->
official-protocol instance AP.  This shows that the loss stack, the
optimizer and the decode chain learn a working detector, the property the
reference shows by training on Cityscapes (reference src/main.py:24-198 +
src/lib/trains/polydet.py:38-162).  On DLA-34 it trains through the DCN
kernels (exact forward and backward on the card), and `eval_dcn` /
`offset_r` re-score the same trained weights under another DCN mode and
measure how often the learned offsets would saturate a clamp at R.

    python -m centerpoly_tpu_torch.tools.train_convergence [--arch res_18]
        [--rep cartesian] [--poly_loss l1] [--epochs 60] [--images 8]
        [--input_h 128] [--input_w 256] [--bar 0.5] [--eval_dcn rowband:4]
        [--offset_stats 4] [--device cpu]

Prints one line `RESULT {json}` with the AP trajectory and pass/fail
against the bar.  Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from ..data.datasets import CityscapesMeta
from ..data.fixture import rect_poly
from ..eval.harness import run_instance_eval
from ..utils.png import read_frame, write_frame


def make_dataset(root: str, n_images: int, seed: int, h: int, w: int):
    """The JAX harness's fixture: dark noise frames with 1-3 filled
    rectangles (drawn by slicing: cv2.rectangle's filled [y0, y0 + bh] x
    [x0, x0 + bw]), as PNG under <root>/imgs, their annotations in
    <root>/ann.json and the GT instance ids by image id (str), 26000 + the
    running annotation count.  Returns (ann_path, img_dir, gt_images)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    gt_images = {}
    for i in range(n_images):
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        gt = np.zeros((h, w), np.int32)
        for k in range(1 + int(rng.randint(0, 3))):
            bw = int(rng.randint(w // 8, w // 3))
            bh = int(rng.randint(h // 6, h // 2))
            x0 = int(rng.randint(2, w - bw - 3))
            y0 = int(rng.randint(2, h - bh - 3))
            color = [int(c) for c in rng.randint(140, 256, 3)]
            img[y0:y0 + bh + 1, x0:x0 + bw + 1] = color
            poly = rect_poly(x0, y0, bw, bh)
            annotations.append({
                "id": len(annotations), "image_id": i, "category_id": 3,
                "bbox": [float(x0), float(y0), float(bw), float(bh)],
                "poly": poly.reshape(-1).tolist(), "pseudo_depth": k,
                "area": float(bw * bh)})
            gt[y0:y0 + bh + 1, x0:x0 + bw + 1] = 26000 + len(annotations)
        images.append({"id": i, "file_name": f"img_{i}.png",
                       "height": h, "width": w})
        write_frame(os.path.join(img_dir, f"img_{i}.png"), img)
        gt_images[str(i)] = gt
    ann_path = os.path.join(root, "ann.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": n} for c, n in
                                  enumerate(CityscapesMeta.class_name[1:9],
                                            1)]}, f)
    return ann_path, img_dir, gt_images


class FixtureMeta(CityscapesMeta):
    """CityscapesMeta scored against the fixture's in-memory GT at the
    fixture's frame size; `last_res` holds the last evaluator dict."""

    def __init__(self, root: str, gt_images, image_size):
        super().__init__(root)
        self.gt_images = gt_images
        self.eval_image_size = tuple(image_size)
        self.last_res = None

    def run_eval(self, results, save_dir, annotations=None,
                 thresh: float = 0.05):
        self.last_res = run_instance_eval(self, results, save_dir,
                                          gt_images=self.gt_images,
                                          thresh=thresh)
        return self.last_res


def _ap50(meta: FixtureMeta) -> float:
    return float((meta.last_res or {}).get("allAp50%") or 0.0)


def make_trainer(root: str, arch="res_18", rep="cartesian", poly_loss="l1",
                 epochs=60, n_images=8, input_h=128, input_w=256,
                 batch_size=4, lr=2.5e-4, seed=0, poly_order=False,
                 device=None):
    """The fixture under `root` and the Trainer that overfits it (the JAX
    harness's config: fixed geometry, no colour jitter, K=16).  Returns
    (trainer, fixture meta, image dir)."""
    from ..configs import Config
    from ..data import CocoPolyAnnotations, Loader, PolydetSampler
    from ..train.trainer import Trainer

    ann_path, img_dir, gt_images = make_dataset(
        root, n_images, seed, input_h, input_w)
    cfg = Config(task="polydet", dataset="cityscapes", arch=arch,
                 input_h=input_h, input_w=input_w, batch_size=batch_size,
                 K=16, rep=rep, poly_loss=poly_loss, lr=lr,
                 num_epochs=epochs, val_intervals=0, num_workers=0,
                 # overfit: keep geometry fixed, no colour jitter
                 not_rand_crop=True, shift=0.0, scale=0.0, flip=0.0,
                 no_color_aug=True, poly_order=poly_order)
    meta = FixtureMeta(root, gt_images, (input_h, input_w))
    ann = CocoPolyAnnotations(ann_path)
    train_sampler = PolydetSampler(cfg, meta, ann, split="train",
                                   img_dir=img_dir)
    train_loader = Loader(train_sampler, len(train_sampler), batch_size,
                          shuffle=True, drop_last=True, num_workers=0)
    val_sampler = PolydetSampler(cfg, meta, ann, split="val",
                                 img_dir=img_dir)
    val_loader = Loader(val_sampler, len(val_sampler), batch_size,
                        shuffle=False, drop_last=False)
    trainer = Trainer(cfg, train_loader, val_loader, device=device,
                      dataset_meta=meta)
    return trainer, meta, img_dir


def run(arch="res_18", rep="cartesian", poly_loss="l1", epochs=60,
        n_images=8, input_h=128, input_w=256, batch_size=4, lr=2.5e-4,
        bar=0.5, seed=0, root=None, val_every=10, poly_order=False,
        eval_dcn=None, offset_r=None, log=print, device=None):
    """Train until AP50 >= bar (checked every `val_every` epochs and at
    the last) or `epochs`; returns the JAX harness's result dict.
    `eval_dcn`: re-score the same trained weights with this DCN mode
    (a second Trainer with cfg.dcn_kernel = eval_dcn).  `offset_r`: the
    learned offsets' saturation at R on the first training frame."""
    from ..train.trainer import Trainer

    root = root or tempfile.mkdtemp(prefix="conv_")
    trainer, meta, img_dir = make_trainer(
        root, arch, rep, poly_loss, epochs, n_images, input_h, input_w,
        batch_size, lr, seed, poly_order, device)
    cfg = trainer.cfg
    train_loader, val_loader = trainer.train_loader, trainer.val_loader

    save_dir = os.path.join(root, "out")
    os.makedirs(save_dir, exist_ok=True)
    t0 = time.time()
    traj = []
    ap = ap50 = 0.0
    for epoch in range(1, epochs + 1):
        trainer.run_epoch(epoch)
        if epoch % val_every == 0 or epoch == epochs:
            _, ap = trainer.validate(epoch, save_dir)
            ap = ap or 0.0
            ap50 = _ap50(meta)
            traj.append({"epoch": epoch, "ap": ap, "ap50": ap50,
                         "steps": epoch * len(train_loader)})
            log(f"epoch {epoch}: AP {ap:.4f} AP50 {ap50:.4f}")
            # the bar is AP50: the 16-gon raster ceiling caps the
            # higher-IoU thresholds well below 1 even for a perfect fit
            if ap50 >= bar:
                break
    result = {
        "arch": arch, "rep": rep, "poly_loss": poly_loss,
        "images": n_images, "input": [input_h, input_w],
        "epochs_run": traj[-1]["epoch"] if traj else 0,
        "steps": traj[-1]["steps"] if traj else 0,
        "ap_trajectory": traj, "final_ap": ap, "final_ap50": ap50,
        "bar": bar, "passed": ap50 >= bar,
        "wall_s": round(time.time() - t0, 1),
    }

    if eval_dcn:
        # the same trained weights scored with the DCN path switched (e.g.
        # trained exact -> eval rowband:4): no retraining
        trainer2 = Trainer(dataclasses.replace(cfg, dcn_kernel=eval_dcn),
                           train_loader, val_loader, device=device,
                           dataset_meta=meta)
        trainer2.state.model.load_state_dict(trainer.state.model.state_dict())
        _, ap_x = trainer2.validate(traj[-1]["epoch"] + 1 if traj else 1,
                                    save_dir)
        result["eval_dcn"] = eval_dcn
        result["eval_dcn_ap"] = ap_x or 0.0
        result["eval_dcn_ap50"] = _ap50(meta)
        result["eval_dcn_ap50_delta"] = round(
            result["eval_dcn_ap50"] - ap50, 6)
        log(f"eval under {eval_dcn}: AP50 {result['eval_dcn_ap50']:.4f} "
            f"(delta {result['eval_dcn_ap50_delta']:+.4f})")

    if offset_r is not None:
        # learned-offset saturation at band R on the trained weights
        # (tools/analyze_dcn_offsets.py, in memory), on the frame flipped
        # to RGB as the JAX harness feeds it
        from .analyze_dcn_offsets import collect, offset_stats
        img = read_frame(os.path.join(img_dir, "img_0.png"))[:, :, ::-1]
        inter = collect(cfg, variables=trainer.state.model.state_dict(),
                        image=np.ascontiguousarray(img), device=device)
        rows = offset_stats(inter, float(offset_r))
        result["offset_stats_r"] = float(offset_r)
        result["offset_stats"] = rows
        result["worst_node_frac_y_clamped"] = max(
            (row["y_frac_clamped_at_r"] for row in rows), default=0.0)
        log(f"offset saturation at R={offset_r}: worst node y-frac "
            f"{result['worst_node_frac_y_clamped']}")

    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="res_18")
    p.add_argument("--rep", default="cartesian")
    p.add_argument("--poly_loss", default="l1")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--input_h", type=int, default=128)
    p.add_argument("--input_w", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--bar", type=float, default=0.5)
    p.add_argument("--val_every", type=int, default=10)
    p.add_argument("--poly_order", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (the card by default; cpu to run on "
                        "the CPU)")
    p.add_argument("--eval_dcn", default=None,
                   help="after training, re-score the same weights with "
                        "this DCN mode (e.g. rowband:4) and report the "
                        "AP50 delta")
    p.add_argument("--offset_stats", type=float, default=None,
                   metavar="R",
                   help="after training, report learned DCN |offset| "
                        "percentiles and the share a [-R, R] clamp would "
                        "saturate")
    args = p.parse_args(argv)
    res = run(arch=args.arch, rep=args.rep, poly_loss=args.poly_loss,
              epochs=args.epochs, n_images=args.images,
              input_h=args.input_h, input_w=args.input_w,
              batch_size=args.batch_size, lr=args.lr, bar=args.bar,
              val_every=args.val_every, poly_order=args.poly_order,
              eval_dcn=args.eval_dcn, offset_r=args.offset_stats,
              device=args.device)
    print("RESULT " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
