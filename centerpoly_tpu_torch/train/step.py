"""Train and eval steps (the JAX package's train/step.py; reference
base_trainer.run_epoch body, base_trainer.py:64-134): forward in train
mode, head maps to NHWC f32 for the loss (step.py:65-69), backward, one
Adam update.  PyTorch runs eagerly; there is nothing to compile.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

from ..losses import PolydetLossConfig, polydet_loss


def loss_fn_for_task(task: str) -> Callable:
    """task -> loss(outputs, batch, cfg) -> (loss, stats)."""
    if task == "polydet":
        return polydet_loss
    raise NotImplementedError(f"no train loss for task '{task}' in the port "
                              f"yet (ROADMAP.md queue A, secondary surface)")


def to_device(batch: Mapping, device, dtype=torch.float32
              ) -> Dict[str, torch.Tensor]:
    """Host batch (numpy, NHWC) -> tensors on `device`; the input becomes
    an NCHW view of its NHWC data (channels_last), 'meta' is dropped."""
    out = {}
    for k, v in batch.items():
        if k == "meta":
            continue
        t = torch.as_tensor(np.asarray(v))
        if t.is_floating_point():
            t = t.to(torch.float32)
        out[k] = t.to(device, non_blocking=True)
    out["input"] = out["input"].to(dtype).permute(0, 3, 1, 2)
    return out


def _nhwc_f32(outs):
    return [{k: v.permute(0, 2, 3, 1).float() for k, v in o.items()}
            for o in outs]


def _autocast(device: torch.device, dtype: torch.dtype):
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


def make_train_step(loss_cfg: PolydetLossConfig,
                    loss_callable: Callable | None = None,
                    dtype: torch.dtype = torch.float32) -> Callable:
    """train_step(state, batch) -> (state, stats): `batch` from `to_device`;
    stats stay on the device.  `dtype` bfloat16 runs the model's forward
    under autocast (parameters and Adam stay f32)."""
    task_loss = loss_callable or polydet_loss

    def train_step(state, batch):
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with _autocast(batch["input"].device, dtype):
            outs = model(batch["input"])
        loss, stats = task_loss(_nhwc_f32(outs), batch, loss_cfg)
        loss.backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in stats.items()}

    return train_step


def make_eval_step(loss_cfg: PolydetLossConfig,
                   loss_callable: Callable | None = None,
                   dtype: torch.dtype = torch.float32) -> Callable:
    """eval_step(state, batch) -> (head maps NHWC f32, stats): forward in
    eval mode (running BatchNorm statistics) + loss, no gradient."""
    task_loss = loss_callable or polydet_loss

    @torch.no_grad()
    def eval_step(state, batch):
        model = state.model.eval()
        with _autocast(batch["input"].device, dtype):
            outs = _nhwc_f32(model(batch["input"]))
        _, stats = task_loss(outs, batch, loss_cfg)
        return outs[-1], stats

    return eval_step
