"""Training orchestration: the epoch loop, validation, checkpoints (the
JAX package's train/trainer.py; reference src/main.py:24-198 and
base_trainer.py:64-149): per-epoch train, model_last every epoch,
periodic val gating model_best, --resume from model_last (+ optimizer).

Validation computes the val loss only (the AP evaluator is not ported,
ROADMAP.md queue A, eval), so model_best is gated on -val_loss: the JAX
package's own rule when AP is unavailable (trainer.py:291-292).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..configs import Config
from ..infer.detector import resolve_device
from ..losses import PolydetLossConfig
from ..models import create_model
from ..utils.logger import Logger
from .checkpoint import load_checkpoint, save_checkpoint
from .state import create_train_state
from .step import loss_fn_for_task, make_eval_step, make_train_step, to_device


def loss_config_for(cfg: Config) -> PolydetLossConfig:
    """The per-task loss config from the experiment config."""
    if cfg.task == "polydet":
        return PolydetLossConfig(
            hm_weight=cfg.hm_weight, off_weight=cfg.off_weight,
            poly_weight=cfg.poly_weight, depth_weight=cfg.depth_weight,
            rep=cfg.rep, poly_loss=cfg.poly_loss, poly_order=cfg.poly_order,
            reg_offset=cfg.reg_offset, mse_loss=cfg.mse_loss)
    raise NotImplementedError(f"no loss config for task '{cfg.task}' in the "
                              f"port yet")


class Trainer:
    """Polydet training on one device (the card unless `device` says
    otherwise), from the seeded init."""

    def __init__(self, cfg: Config, train_loader, val_loader=None,
                 logger: Optional[Logger] = None, device=None):
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
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
                                          self.dtype)
        self.eval_step = make_eval_step(self.loss_cfg, loss_callable,
                                        self.dtype)
        # -inf: the gate metric -val_loss starts below -1 on a fresh model
        self.best = float("-inf")
        self.start_epoch = 0
        n_params = sum(p.numel() for p in model.parameters())
        self._log(f"model {cfg.arch}: {n_params / 1e6:.2f}M parameters\n")

    def _log(self, txt: str):
        if self.logger is not None:
            self.logger.write(txt)
        else:
            print(txt, end="")

    def put(self, batch) -> Dict[str, torch.Tensor]:
        return to_device(batch, self.device)

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the train loader.  Per-step stats stay on the
        device and are read once at the end, so the host does not wait on
        the card every step."""
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        t0 = time.time()
        n = 0
        for batch in self.train_loader:
            bsz = batch["input"].shape[0]
            self.state, stats = self.train_step(self.state, self.put(batch))
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

    def validate(self, epoch: int, save_dir: str):
        """Val loss over the val loader.  Returns (val_loss, None): the AP
        evaluator is not ported yet."""
        del save_dir
        if self.val_loader is None:
            return None, None
        sums: Dict[str, float] = {}
        count = 0
        for batch in self.val_loader:
            bsz = batch["input"].shape[0]
            _, stats = self.eval_step(self.state, self.put(batch))
            for k, v in stats.items():
                sums[k] = sums.get(k, 0.0) + float(v) * bsz
            count += bsz
        avg = {k: s / count for k, s in sums.items()}
        self._log(f"val   {epoch} | " +
                  " ".join(f"{k} {v:.4f}" for k, v in avg.items()) + "\n")
        if self.logger is not None:
            for k, v in avg.items():
                self.logger.scalar_summary(f"val_{k}", v, epoch)
        return avg.get("loss"), None

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
            save_checkpoint(save_dir, "last", self.state, epoch)
            if cfg.val_intervals > 0 and epoch % cfg.val_intervals == 0:
                val_loss, ap = self.validate(epoch, save_dir)
                metric = ap if ap is not None else (
                    -val_loss if val_loss is not None else None)
                if metric is not None and metric > self.best:
                    self.best = metric
                    save_checkpoint(save_dir, "best", self.state, epoch)
        return self.state
