"""Train entry point:

    python -m centerpoly_tpu_torch.main polydet --dataset cityscapes \
        --data_dir <root> [--device cpu] ...

(reference surface: src/main.py; the JAX package's main.py).  Trains on
the card unless `--device cpu` is given.  Frames are read from the
annotations' file names under the dataset's image directory (`.npy`
with numpy, PNG with utils/png.py; JPEG needs cv2).  With
`--val_intervals N` every N-th epoch validates: val loss, then the
instance AP of the decoded val results (with GT maps for the heads the
`--eval_oracle_*` flags name), which gates model_best.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def main(argv=None, device=None):
    from .configs import Config
    from .data import DATASETS, SAMPLERS, CocoPolyAnnotations, Loader
    from .train.trainer import Trainer
    from .utils.logger import Logger

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    cfg = Config.from_args(argv)
    np.random.seed(cfg.seed)

    meta_cls = DATASETS.get(cfg.dataset)
    if meta_cls is None:
        raise SystemExit(f"dataset '{cfg.dataset}' has no adapter in the port")
    meta = meta_cls(cfg.data_dir, cfg.nbr_points)
    sampler_cls = SAMPLERS.get(cfg.task)
    if sampler_cls is None:
        raise SystemExit(f"task '{cfg.task}' has no sampler in the port")
    train_ann = CocoPolyAnnotations(meta.annot_path("train"))
    train_sampler = sampler_cls(cfg, meta, train_ann, split="train",
                                img_dir=meta.img_dir("train"))
    train_loader = Loader(train_sampler, len(train_sampler), cfg.batch_size,
                          shuffle=True, seed=cfg.seed,
                          num_workers=cfg.num_workers)
    val_loader = None
    try:
        val_ann = CocoPolyAnnotations(meta.annot_path("val"))
        val_sampler = sampler_cls(cfg, meta, val_ann, split="val",
                                  img_dir=meta.img_dir("val"))
        val_loader = Loader(val_sampler, len(val_sampler), cfg.batch_size,
                            shuffle=False, drop_last=False)
    except FileNotFoundError:
        pass

    save_dir = os.path.join(cfg.save_dir, cfg.dataset, cfg.task, cfg.exp_id)
    os.makedirs(save_dir, exist_ok=True)
    logger = Logger(save_dir, cfg.to_json())
    try:
        trainer = Trainer(cfg, train_loader, val_loader, logger, device=device,
                          dataset_meta=meta)
        trainer.fit(save_dir)
    finally:
        logger.close()
    return trainer


if __name__ == "__main__":
    main()
