"""Training orchestration: the epoch loop, validation, checkpoints (the
JAX package's train/trainer.py; reference src/main.py:24-198 and
base_trainer.py:64-149): per-epoch train, model_last every epoch,
periodic val with AP gating model_best (main.py:162-186), --resume from
model_last (+ optimizer), oracle head substitution during polydet's val
(trains/polydet.py:49-70).

Validation decodes each val batch on the host (polydet's polygons or
ctdet's boxes), runs the dataset's eval and gates model_best on its AP:
Cityscapes' `allAp` for polydet, the COCO-protocol `AP` of the box
datasets; without GT, and for exdet, multi_pose and ddd, whose val batches
the JAX package does not decode (trainer.py:160-163), it gates on
-val_loss, the JAX package's rule (trainer.py:291-292).

Over a process group (train/mesh.py; one rank per card, each with its
shard of the loaders) the steps are data parallel (train/step.py), and
rank 0 alone logs and writes checkpoints.  Validation gathers the ranks'
decoded val results to rank 0, which adds the samples no shard held this
epoch and scores the whole val split once, as the JAX package's
single-host mesh does; rank 0's model_best decision reaches every rank.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import Config
from ..data.datasets import eval_kwargs
from ..data.loader import stack_batch
from ..infer.detector import (ctdet_post_process, polydet_post_process,
                              resolve_device)
from ..losses import (CtdetLossConfig, DddLossConfig, ExdetLossConfig,
                      MultiPoseLossConfig, PolydetLossConfig)
from ..models import create_model
from ..ops.decode import ctdet_decode, polydet_decode
from ..utils.oracle import apply_oracles
from ..utils.logger import Logger
from ..utils.timers import span
from .checkpoint import load_checkpoint, save_checkpoint
from .state import create_train_state
from .step import loss_fn_for_task, make_eval_step, make_train_step, to_device


ORACLE_FLAGS = ("eval_oracle_hm", "eval_oracle_poly", "eval_oracle_offset",
                "eval_oracle_pseudo_depth")


def loss_config_for(cfg: Config):
    """The per-task loss config from the experiment config."""
    if cfg.task == "polydet":
        return PolydetLossConfig(
            hm_weight=cfg.hm_weight, off_weight=cfg.off_weight,
            poly_weight=cfg.poly_weight, depth_weight=cfg.depth_weight,
            rep=cfg.rep, poly_loss=cfg.poly_loss, poly_order=cfg.poly_order,
            reg_offset=cfg.reg_offset, mse_loss=cfg.mse_loss)
    if cfg.task == "ctdet":
        return CtdetLossConfig(
            hm_weight=cfg.hm_weight, off_weight=cfg.off_weight,
            wh_weight=cfg.wh_weight, mse_loss=cfg.mse_loss,
            reg_loss=cfg.reg_loss, dense_wh=cfg.dense_wh,
            norm_wh=cfg.norm_wh, cat_spec_wh=cfg.cat_spec_wh,
            reg_offset=cfg.reg_offset)
    if cfg.task == "ddd":
        return DddLossConfig(
            hm_weight=cfg.hm_weight, dep_weight=cfg.dep_weight,
            dim_weight=cfg.dim_weight, rot_weight=cfg.rot_weight,
            wh_weight=cfg.wh_weight, off_weight=cfg.off_weight,
            mse_loss=cfg.mse_loss, reg_bbox=cfg.reg_bbox,
            reg_offset=cfg.reg_offset)
    if cfg.task == "exdet":
        return ExdetLossConfig(
            hm_weight=cfg.hm_weight, off_weight=cfg.off_weight,
            mse_loss=cfg.mse_loss, reg_offset=cfg.reg_offset)
    if cfg.task == "multi_pose":
        return MultiPoseLossConfig(
            hm_weight=cfg.hm_weight, wh_weight=cfg.wh_weight,
            off_weight=cfg.off_weight, hp_weight=cfg.hp_weight,
            hm_hp_weight=cfg.hm_hp_weight, mse_loss=cfg.mse_loss,
            reg_loss=cfg.reg_loss, dense_hp=cfg.dense_hp,
            hm_hp=cfg.hm_hp, reg_hp_offset=cfg.reg_hp_offset,
            reg_offset=cfg.reg_offset)
    raise ValueError(f"unknown task {cfg.task!r}: no loss config")


class Trainer:
    """Training of a task (polydet, ctdet, exdet, multi_pose, ddd) on one
    device (the card unless `device` says otherwise), from the seeded
    init; data parallel over `group`."""

    def __init__(self, cfg: Config, train_loader, val_loader=None,
                 logger: Optional[Logger] = None, device=None, *,
                 dataset_meta=None, group=None):
        """`dataset_meta`: the DatasetMeta whose `run_eval` scores the val
        results (AP); without it validation gates on -val_loss.  `group`:
        a process group whose every rank builds a Trainer on its own
        device (train/mesh.py::make_mesh) with its shard of the loaders."""
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.meta = dataset_meta
        self.logger = logger
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)
        self.device = resolve_device(device)
        if cfg.train_dtype not in ("float32", "bf16", "bfloat16"):
            raise ValueError(f"train_dtype={cfg.train_dtype!r}")
        self.dtype = (torch.float32 if cfg.train_dtype == "float32"
                      else torch.bfloat16)
        self.loss_cfg = loss_config_for(cfg)
        loss_callable = loss_fn_for_task(cfg.task)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = create_model(cfg.arch, cfg.heads, cfg.head_conv,
                                 dcn_kernel=cfg.dcn_kernel)
        fmt = (torch.channels_last if self.device.type == "cuda"
               else torch.contiguous_format)
        model.to(self.device, memory_format=fmt)
        self.state = create_train_state(
            model, base_lr=cfg.lr, lr_steps=cfg.lr_step,
            steps_per_epoch=max(1, len(train_loader)), grad_clip=cfg.grad_clip)
        self.train_step = make_train_step(self.loss_cfg, loss_callable,
                                          self.dtype, group=group)
        self.eval_step = make_eval_step(self.loss_cfg, loss_callable,
                                        self.dtype, group=group)
        # rank 0's eval of the val samples that no shard held
        self.local_eval_step = make_eval_step(self.loss_cfg, loss_callable,
                                              self.dtype)
        # -inf: the fallback gate metric -val_loss starts below -1 on a
        # fresh model
        self.best = float("-inf")
        self.start_epoch = 0
        n_params = sum(p.numel() for p in model.parameters())
        self._log(f"model {cfg.arch}: {n_params / 1e6:.2f}M parameters\n")

    def _log(self, txt: str):
        if self.rank != 0:
            return
        if self.logger is not None:
            self.logger.write(txt)
        else:
            print(txt, end="")

    def put(self, batch) -> Dict[str, torch.Tensor]:
        return to_device(batch, self.device)

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the train loader.  Per-step stats stay on the
        device and are read once at the end, so the host does not wait on
        the card every step.  Beside the step's spans, `train.next_batch`
        is the wait on the loader and `train.put` the batch's upload."""
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        t0 = time.time()
        n = 0
        batches = iter(self.train_loader)
        while True:
            with span("train.next_batch"):
                batch = next(batches, None)
            if batch is None:
                break
            bsz = batch["input"].shape[0]
            with span("train.put"):
                on_device = self.put(batch)
            self.state, stats = self.train_step(self.state, on_device)
            for k, v in stats.items():
                sums[k] = sums[k] + v * bsz if k in sums else v * bsz
            count += bsz
            n += 1
        avg = {k: float(s) / count for k, s in sums.items()}
        dt = time.time() - t0
        self._log(f"epoch {epoch} | {n} iters | {dt:.1f}s | " +
                  " ".join(f"{k} {v:.4f}" for k, v in avg.items()) + "\n")
        if self.logger is not None:
            for k, v in avg.items():
                self.logger.scalar_summary(f"train_{k}", v, epoch)
        return avg

    def _decode_outputs(self, outs, batch) -> Optional[Dict]:
        """Decode a val batch's head maps (NHWC) into per-image results
        {img_id: {class: (n, 5+2N+1) array}} on the host (ref
        trains/polydet.py:220-237), with the GT maps in place of the heads
        the oracle flags name; the GT `hm` is taken as probabilities, a
        predicted one through the sigmoid.  ctdet's are (n, 5) box rows
        (`_decode_ctdet`)."""
        if "meta" not in batch:
            return None
        if self.cfg.task == "ctdet":
            return self._decode_ctdet(outs, batch)
        if self.cfg.task != "polydet":
            return None
        cfg = self.cfg
        heads = {k: v.detach().float().cpu().numpy() if torch.is_tensor(v)
                 else np.asarray(v, np.float32) for k, v in outs.items()}
        if any(getattr(cfg, f) for f in ORACLE_FLAGS):
            gt_like = {k: np.asarray(v) for k, v in batch.items()
                       if k != "meta"}
            oracled = apply_oracles(heads, gt_like, cfg)
            hm = _tensor(oracled["hm"]) if cfg.eval_oracle_hm \
                else torch.sigmoid(_tensor(heads["hm"]))
            heads = {**heads, **oracled}
        else:
            hm = torch.sigmoid(_tensor(heads["hm"]))
        dets = polydet_decode(
            hm, _tensor(heads["poly"]), _tensor(heads["pseudo_depth"]),
            reg=_tensor(heads["reg"]) if cfg.reg_offset else None,
            k=cfg.K, rep=cfg.rep).numpy()
        results = {}
        length = 5 + 2 * cfg.nbr_points + 1
        for i, m in enumerate(batch["meta"]):
            pp = polydet_post_process(
                dets[i:i + 1], [m["c"]], [m["s"]],
                cfg.output_h, cfg.output_w, cfg.num_classes)[0]
            for j in range(1, cfg.num_classes + 1):
                pp[j] = np.array(pp[j], np.float32).reshape(-1, length)
            results[int(m["img_id"])] = pp
        return results

    def _decode_ctdet(self, outs, batch) -> Dict:
        """A ctdet val batch's head maps -> {img_id: {class: (n, 5)
        [x0, y0, x1, y1, score] rows}} on the host (ref trains/ctdet.py:
        137-150)."""
        cfg = self.cfg
        heads = {k: _tensor(v.detach().float().cpu().numpy()
                            if torch.is_tensor(v) else v)
                 for k, v in outs.items()}
        dets = ctdet_decode(
            torch.sigmoid(heads["hm"]), heads["wh"],
            reg=heads["reg"] if cfg.reg_offset else None, k=cfg.K,
            cat_spec_wh=cfg.cat_spec_wh).numpy()
        results = {}
        for i, m in enumerate(batch["meta"]):
            pp = ctdet_post_process(
                dets[i:i + 1], [m["c"]], [m["s"]],
                cfg.output_h, cfg.output_w, cfg.num_classes)[0]
            for j in range(1, cfg.num_classes + 1):
                pp[j] = np.array(pp[j], np.float32).reshape(-1, 5)
            results[int(m["img_id"])] = pp
        return results

    def validate(self, epoch: int, save_dir: str):
        """Val loss over the val loader and, when the dataset meta can
        evaluate, the AP of the decoded val results: the instance AP's
        `allAp`, or, where the evaluator gives none, the box evaluators'
        `AP` (JAX trainer.py:262-266).  Returns (val_loss, ap or None)."""
        if self.val_loader is None:
            return None, None
        sums: Dict[str, float] = {}
        count = 0
        results = {}

        def add(step, batch, bsz):
            nonlocal count
            outs, stats = step(self.state, self.put(batch))
            for k, v in stats.items():
                sums[k] = sums.get(k, 0.0) + float(v) * bsz
            count += bsz
            if self.meta is not None:
                results.update(self._decode_outputs(outs, batch) or {})

        for batch in self.val_loader:
            # the stats are the global batch's, of world x this shard
            add(self.eval_step, batch, batch["input"].shape[0] * self.world)
        if self.group is not None:
            shards = [None] * self.world
            dist.all_gather_object(shards, results, group=self.group)
            if self.rank != 0:
                return None, None
            for r in shards:
                results.update(r)
            rest = self.val_loader.left_out
            if len(rest):
                add(self.local_eval_step, stack_batch(
                    [self.val_loader.sampler(int(i)) for i in rest]),
                    len(rest))
        avg = {k: s / count for k, s in sums.items()}
        self._log(f"val   {epoch} | " +
                  " ".join(f"{k} {v:.4f}" for k, v in avg.items()) + "\n")
        if self.logger is not None:
            for k, v in avg.items():
                self.logger.scalar_summary(f"val_{k}", v, epoch)

        ap = None
        if results:
            why = "no GT instance images"
            try:
                res = self.meta.run_eval(results, save_dir, **eval_kwargs(
                    self.meta, thresh=self.cfg.thresh))
            except OSError as e:        # GT files missing or unreadable
                res, why = None, str(e)
            ap_val = None if res is None else res.get("allAp", res.get("AP"))
            if ap_val is None:
                self._log(f"val {epoch} | AP eval skipped: {why}\n")
            else:
                ap = float(ap_val)
                ap50 = res.get("allAp50%", res.get("AP50"))
                self._log(f"val   {epoch} | AP {round(ap, 4)} AP50 {ap50}\n")
                if self.logger is not None:
                    self.logger.scalar_summary("val_AP", ap, epoch)
        return avg.get("loss"), ap

    def fit(self, save_dir: str, num_epochs: Optional[int] = None):
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        if cfg.resume:
            try:
                self.state, self.start_epoch, _ = load_checkpoint(
                    save_dir, "last", self.state)
                self._log(f"resumed from epoch {self.start_epoch}\n")
            except (OSError, KeyError, RuntimeError) as e:
                self._log(f"resume requested but no usable model_last "
                          f"({e}); starting fresh\n")
        for epoch in range(self.start_epoch + 1, num_epochs + 1):
            self.run_epoch(epoch)
            if self.rank == 0:
                save_checkpoint(save_dir, "last", self.state, epoch)
            if cfg.val_intervals > 0 and epoch % cfg.val_intervals == 0:
                val_loss, ap = self.validate(epoch, save_dir)
                # gate best on AP when eval ran, else on -loss
                # (ref main.py:162-186)
                metric = ap if ap is not None else (
                    -val_loss if val_loss is not None else None)
                if self.group is not None:
                    decision = [metric]
                    dist.broadcast_object_list(decision, src=0,
                                               group=self.group)
                    metric = decision[0]
                if metric is not None and metric > self.best:
                    self.best = metric
                    if self.rank == 0:
                        save_checkpoint(save_dir, "best", self.state, epoch)
        return self.state


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))
