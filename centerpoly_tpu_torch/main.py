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

`--batch_size` is the global batch.  On a host with several cards whose
count divides it, `main` runs one process per card (NCCL on localhost),
each loading batch_size / cards, as the JAX package meshes every device.
`--distributed` joins a group launched from outside instead: with
`--coordinator_address host:port --num_processes N --process_id p` on
each of N hosts, as the JAX package counts them, one process a host;
on a host with n cards that process starts n ranks, one a card, and
rank k is global rank p*n + k of N*n (`mesh.host_ranks`).  Or with no
triple under torchrun, which starts every rank itself:

    torchrun --nproc_per_node 4 -m centerpoly_tpu_torch.main polydet \
        --distributed --data_dir <root> --batch_size 32 ...

`--device cpu` (or any named device) keeps one process; with
`--distributed` it joins a gloo group, and the triple then counts
processes, each one rank.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from .train import mesh


def main(argv=None, device=None):
    """Train from `argv` (sys.argv by default).  Returns the Trainer, or
    None when the run was spread over one spawned process per card."""
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
    n = torch.cuda.device_count()
    if device is None and n > 0:
        hosts = None
        if cfg.distributed and cfg.coordinator_address:
            # the JAX package's triple counts processes, each meshing
            # every device of its host (its train/mesh.py:22-56)
            hosts, host = cfg.num_processes, cfg.process_id
        elif not cfg.distributed and n > 1 and cfg.batch_size % n == 0:
            # the JAX Trainer meshes every device when the batch divides
            # (trainer.py:83-85)
            argv = argv + ["--distributed", "--coordinator_address",
                           f"localhost:{mesh.free_port()}"]
            hosts, host = 1, 0
        if hosts is not None:
            # one rank a card over NCCL
            mesh.host_ranks(hosts, host, n)
            torch.multiprocessing.spawn(
                _host_rank_main, args=(argv, hosts, host, n), nprocs=n)
            return None
    np.random.seed(cfg.seed)

    group, rank, world = None, 0, 1
    if cfg.distributed:
        if mesh.initialize_distributed(cfg.coordinator_address,
                                       cfg.num_processes, cfg.process_id,
                                       device=device or "cuda"):
            group = dist.group.WORLD
            rank, world = dist.get_rank(), dist.get_world_size()
            device = mesh.make_mesh(device=device or "cuda")
    if cfg.batch_size % world:
        raise SystemExit(f"--batch_size {cfg.batch_size} (global) does not "
                         f"divide over {world} processes")
    local_batch = cfg.batch_size // world

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
    train_loader = Loader(train_sampler, len(train_sampler), local_batch,
                          shuffle=True, seed=cfg.seed,
                          num_workers=cfg.num_workers, rank=rank, world=world)
    val_loader = None
    try:
        val_ann = CocoPolyAnnotations(meta.annot_path("val"))
        val_sampler = sampler_cls(cfg, meta, val_ann, split="val",
                                  img_dir=meta.img_dir("val"))
        val_loader = Loader(val_sampler, len(val_sampler), local_batch,
                            shuffle=False, drop_last=False, rank=rank,
                            world=world)
    except FileNotFoundError:
        pass

    save_dir = os.path.join(cfg.save_dir, cfg.dataset, cfg.task, cfg.exp_id)
    os.makedirs(save_dir, exist_ok=True)
    logger = Logger(save_dir, cfg.to_json()) if rank == 0 else None
    try:
        trainer = Trainer(cfg, train_loader, val_loader, logger, device=device,
                          dataset_meta=meta, group=group)
        trainer.fit(save_dir)
    finally:
        if logger is not None:
            logger.close()
    return trainer


def _host_rank_main(k, argv, num_processes, process_id, n):
    """Rank k of the n on process `process_id`'s host: global rank
    process_id * n + k of num_processes * n, on card k."""
    rank, world = mesh.host_ranks(num_processes, process_id, n)[k]
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(k), str(n)
    try:
        main(argv + ["--num_processes", str(world), "--process_id",
                     str(rank)], device="cuda")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
