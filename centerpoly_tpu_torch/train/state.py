"""Train state: the model + Adam with the step-decay schedule.

Reference training loop: src/main.py:24-198 (Adam, LR / 10 at each epoch
in `lr_step`, main.py:191-197; optional grad clip, base_trainer.py:
100-101), as the JAX package's train/state.py builds it with optax:
Adam with betas 0.9 / 0.999 and eps 1e-8, the schedule counted in steps,
and the global-norm clip of optax.clip_by_global_norm.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def lr_schedule(base_lr: float, lr_steps: Sequence[int],
                steps_per_epoch: int) -> Callable[[int], float]:
    """LR / 10 at each epoch boundary in lr_steps; like
    optax.piecewise_constant_schedule, the rate of update number `count`
    (0-based) is scaled once for every boundary <= count."""
    boundaries = sorted({int(e) * steps_per_epoch for e in lr_steps})

    def schedule(count: int) -> float:
        lr = base_lr
        for b in boundaries:
            if count >= b:
                lr *= 0.1
        return lr

    return schedule


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients to a global norm of at most `max_norm`, as
    optax.clip_by_global_norm (g / norm * max_norm when norm >= max_norm).
    Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class TrainState:
    """The model, its optimizer and the count of updates applied."""

    def __init__(self, model: torch.nn.Module, schedule: Callable[[int], float],
                 grad_clip: Optional[float] = None,
                 grad_transform: Optional[Callable] = None):
        """`grad_transform(model)`: runs on the gradients before the clip
        and Adam (train/surgery.py::freeze_transform)."""
        self.model = model
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.grad_transform = grad_transform
        self.step = 0
        self.optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                          betas=(0.9, 0.999), eps=1e-8)

    def apply_gradients(self):
        """One Adam update from the gradients in each parameter's .grad."""
        if self.grad_transform is not None:
            self.grad_transform(self.model)
        if self.grad_clip is not None:
            clip_by_global_norm(self.model.parameters(), self.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: torch.nn.Module, base_lr: float = 1.25e-4,
                       lr_steps: Sequence[int] = (90, 120),
                       steps_per_epoch: int = 1000,
                       grad_clip: Optional[float] = None,
                       grad_transform: Optional[Callable] = None) -> TrainState:
    return TrainState(model, lr_schedule(base_lr, lr_steps, steps_per_epoch),
                      grad_clip, grad_transform)
