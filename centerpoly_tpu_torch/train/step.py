"""Train and eval steps (the JAX package's train/step.py; reference
base_trainer.run_epoch body, base_trainer.py:64-134): forward in train
mode, head maps to NHWC f32 for the loss (step.py:65-69), backward, one
Adam update.  PyTorch runs eagerly; there is nothing to compile.  Over a
process group the step is data parallel (`make_train_step`).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..losses import (PolydetLossConfig, ctdet_loss, ddd_loss, exdet_loss,
                      multi_pose_loss, polydet_loss)
from ..models.layers import BatchNorm2d
from ..utils.timers import span
from . import mesh


def loss_fn_for_task(task: str) -> Callable:
    """task -> loss(outputs, batch, cfg, group=None) -> (loss, stats)."""
    losses = {"polydet": polydet_loss, "ctdet": ctdet_loss,
              "exdet": exdet_loss, "multi_pose": multi_pose_loss,
              "ddd": ddd_loss}
    if task in losses:
        return losses[task]
    raise ValueError(f"unknown task {task!r}: the train losses are "
                     f"{', '.join(sorted(losses))}")


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
                    dtype: torch.dtype = torch.float32, group=None,
                    grad_bucket: bool = False) -> Callable:
    """train_step(state, batch) -> (state, stats): `batch` from `to_device`;
    stats stay on the device.  `dtype` bfloat16 runs the model's forward
    under autocast (parameters and Adam stay f32).

    With a process group (train/mesh.py), each rank passes its share of
    the global batch and the stats come out global, the same on every
    rank.  By default the step is the JAX package's mesh step
    (train/step.py:118-125 there): one function of the global batch.
    BatchNorm takes the global batch's statistics (models/layers.py),
    each loss denominator is summed over the group (losses/normalise.py),
    and the model runs wrapped in DistributedDataParallel, whose gradient
    mean of the world-scaled shares is the global loss's gradient.  Rank
    0's parameters reach every rank when the model is wrapped, at the
    first step.  `grad_bucket=True` is the JAX package's bucketed step
    (step.py:86-116 there), the reference DataParallel's rule: per-rank
    BatchNorm and losses, then one mean over the ranks of the flattened
    gradients, of the new running statistics and of the stats.  The clip
    and Adam then run alike on every rank.

    A step's stages are spans inside `train.step` that tile it:
    `train.zero_grad` (train mode, the group's wrapper, zeroed
    gradients), `train.forward`, `train.loss` (the NHWC views and the task
    loss), `train.backward`, `train.allreduce` (over a group: the stats'
    and the bucketed step's reductions) and `train.adam`."""
    task_loss = loss_callable or polydet_loss

    def forward_backward(model, batch, loss_group, scale):
        with span("train.forward"), _autocast(batch["input"].device, dtype):
            outs = model(batch["input"])
        with span("train.loss"):
            loss, stats = task_loss(_nhwc_f32(outs), batch, loss_cfg,
                                    group=loss_group)
            stats = {k: v.detach() for k, v in stats.items()}
        with span("train.backward"):
            (loss if scale == 1.0 else loss * scale).backward()
        return stats

    if group is None:
        def train_step(state, batch):
            with span("train.step"):
                with span("train.zero_grad"):
                    model = state.model.train()
                    state.optimizer.zero_grad(set_to_none=True)
                stats = forward_backward(model, batch, None, 1.0)
                with span("train.adam"):
                    state.apply_gradients()
            return state, stats

        return train_step

    world = dist.get_world_size(group)
    wrapped = {}

    def replica(model):
        """The model as the step runs it, made once per model."""
        if wrapped.get("module") is not model:
            wrapped["module"] = model
            if grad_bucket:
                wrapped["run"] = mesh.replicate(model, group)
            else:
                for m in model.modules():
                    if isinstance(m, BatchNorm2d):
                        m.process_group = group
                dev = next(model.parameters()).device
                # broadcast_buffers off: the running statistics are global
                # already (or averaged, bucketed), not rank 0's
                wrapped["run"] = DistributedDataParallel(
                    model, device_ids=[dev] if dev.type == "cuda" else None,
                    process_group=group, broadcast_buffers=False,
                    find_unused_parameters=True)
        return wrapped["run"]

    def train_step(state, batch):
        with span("train.step"):
            with span("train.zero_grad"):
                model = state.model.train()
                run = replica(model)
                state.optimizer.zero_grad(set_to_none=True)
            if grad_bucket:
                stats = forward_backward(run, batch, None, 1.0)
            else:
                stats = forward_backward(run, batch, group, float(world))
            with span("train.allreduce"):
                if grad_bucket:
                    _mean_over(group, [p.grad for p in model.parameters()
                                       if p.grad is not None])
                    _mean_over(group, [b for n, b in model.named_buffers()
                                       if n.endswith(("running_mean",
                                                      "running_var"))])
                stats = _sum_stats(stats, group,
                                   1.0 / world if grad_bucket else 1.0)
            with span("train.adam"):
                state.apply_gradients()
        return state, stats

    return train_step


@torch.no_grad()
def _mean_over(group, tensors):
    """Replace each tensor by its mean over the group's ranks, with one
    all_reduce of them all flattened into an f32 vector."""
    if not tensors:
        return
    vec = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(vec, group=group)
    vec /= dist.get_world_size(group)
    off = 0
    for t in tensors:
        t.copy_(vec[off:off + t.numel()].view_as(t))
        off += t.numel()


def _sum_stats(stats, group, scale):
    """The stats summed over the group, times `scale`, with one
    all_reduce."""
    keys = sorted(stats)
    vec = torch.stack([stats[k].float().reshape(()) for k in keys])
    dist.all_reduce(vec, group=group)
    return {k: vec[i] * scale for i, k in enumerate(keys)}


def make_eval_step(loss_cfg: PolydetLossConfig,
                   loss_callable: Callable | None = None,
                   dtype: torch.dtype = torch.float32,
                   group=None) -> Callable:
    """eval_step(state, batch) -> (head maps NHWC f32, stats): forward in
    eval mode (running BatchNorm statistics) + loss, no gradient.  With a
    process group each rank passes its share of the global batch, gets
    its own head maps back and the global batch's stats (the ranks'
    numerators over the summed denominators, summed), as the JAX
    package's sharded eval step computes them."""
    task_loss = loss_callable or polydet_loss

    @torch.no_grad()
    def eval_step(state, batch):
        model = state.model.eval()
        with _autocast(batch["input"].device, dtype):
            outs = _nhwc_f32(model(batch["input"]))
        _, stats = task_loss(outs, batch, loss_cfg, group=group)
        if group is not None:
            stats = _sum_stats(stats, group, 1.0)
        return outs[-1], stats

    return eval_step
