"""Loss denominators over a process group.

In a data-parallel step (train/step.py) each rank holds a share of the
global batch.  With a group, a masked-mean loss on one rank is its own
numerator over the global denominator (the ranks' denominators summed, no
gradient), and an additive constant is split evenly, so the ranks' shares
sum to the loss of the global batch: the function the JAX package's mesh
step computes.  Without a group these are the identity, and each loss is
the one-device function, bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` summed over the group's ranks (no gradient); `x` without one."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def share(group=None) -> float:
    """This rank's share of a constant term: 1 / world, 1 without a group."""
    return 1.0 if group is None else 1.0 / dist.get_world_size(group)


def mse_mean(pred: torch.Tensor, target: torch.Tensor,
             group=None) -> torch.Tensor:
    """Mean squared error over every element of the batch, the global
    batch with a group (the heat-map terms under mse_loss)."""
    sq = (pred - target) ** 2
    if group is None:
        return torch.mean(sq)
    return sq.sum() / global_sum(sq.new_tensor(sq.numel()), group)
