"""Data parallelism over cards: the JAX package's 1-D 'data' mesh
(train/mesh.py there) in PyTorch's idiom, one process per card.

JAX runs one program over a mesh of devices, and GSPMD inserts the
collectives.  The port runs one process (rank) per card in a
`torch.distributed` process group.  Each rank holds a replica of the model
on its own card and loads its share of the global batch.  The train step
(train/step.py) takes BatchNorm statistics and loss denominators over the
global batch with collectives and averages the gradients with
DistributedDataParallel, so a step computes what JAX's mesh step computes.

  initialize_distributed  join the default group: NCCL for the card, gloo
                          for the CPU
  make_mesh               this rank's device, pinned with set_device
  shard_batch             this rank's slice of a host batch
  replicate               rank 0's parameters and buffers on every rank
  serving_devices         the first n cards, one replica each (run_batch)
  host_ranks              the ranks of one process of the explicit triple

A rank finds its card from LOCAL_RANK and LOCAL_WORLD_SIZE, which
torchrun sets, and `main` sets for the ranks it starts.  The explicit
--coordinator_address / --num_processes N / --process_id p triple counts
processes, one a host, as the JAX package's does: `main` starts one rank
a card of the host (`host_ranks`).  Without LOCAL_RANK a rank takes its
global rank as its index on the host, which is right on one host only.
"""
from __future__ import annotations

import os
import socket
from typing import Mapping

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """NCCL for a card, gloo for the CPU; never one in place of the other."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: str = "",
                           num_processes: int = -1, process_id: int = -1,
                           device="cuda") -> bool:
    """Join the default process group, once per process, before any
    collective.  Explicit values (`--coordinator_address host:port
    --num_processes N --process_id i`) meet over tcp://; with none given,
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    does.  `device` is what this process computes on and picks the
    backend.  Returns True when a group of more than one process is up,
    False for an explicit single-process launch (as the JAX package's
    initialize_distributed)."""
    if num_processes == 1:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for an NCCL group: pass "
                           "device='cpu' to train on the CPU over gloo")
    explicit = {"--coordinator_address": bool(coordinator_address),
                "--num_processes": num_processes > 0,
                "--process_id": process_id >= 0}
    if all(explicit.values()):
        dist.init_process_group(
            backend_for(device), init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    elif not any(explicit.values()) and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend_for(device), init_method="env://")
    else:
        missing = [k for k, given in explicit.items() if not given]
        raise ValueError(f"--distributed needs {', '.join(missing)} (or all "
                         f"three left out under torchrun)")
    return dist.get_world_size() > 1


def host_ranks(num_processes: int, process_id: int, n_local: int
               ) -> list[tuple[int, int]]:
    """(global rank, world size) of each of the `n_local` ranks, one a
    card, that process `process_id` of `num_processes` runs: the JAX
    package's process meshes every device of its host, so its host's
    ranks are process_id * n_local + k of num_processes * n_local, and a
    global batch splits over them as JAX's does over the processes."""
    if not 0 <= process_id < num_processes or n_local < 1:
        raise ValueError(f"process {process_id} of {num_processes} with "
                         f"{n_local} cards")
    world = num_processes * n_local
    return [(process_id * n_local + k, world) for k in range(n_local)]


def local_rank() -> int:
    """This process's index among the ranks of its host: LOCAL_RANK (set
    by torchrun), else the global rank, which is right on one host only."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(n_devices: int | None = None, device="cuda") -> torch.device:
    """This rank's device: `cuda:{local_rank}`, made the current card
    (every rank would otherwise run on card 0), or the CPU for
    device='cpu'.  `n_devices` is the number of ranks on this host
    (torchrun's LOCAL_WORLD_SIZE, else the group's size); raises when the
    host has fewer cards (as on several hosts launched without
    LOCAL_WORLD_SIZE, where every rank counts the whole group)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if n_devices is None:
        n_devices = int(os.environ.get(
            "LOCAL_WORLD_SIZE",
            dist.get_world_size() if dist.is_initialized() else 1))
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(f"{n_devices} ranks on this host but {have} "
                           f"CUDA devices (on several hosts, launch with "
                           f"torchrun or set LOCAL_RANK and "
                           f"LOCAL_WORLD_SIZE)")
    index = local_rank()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def shard_batch(batch: Mapping, rank: int, world: int) -> dict:
    """This rank's contiguous slice of the leading axis of every entry of
    a host batch (JAX's P('data') sharding): rank r of `world` gets
    samples [r B/world, (r+1) B/world).  The batch must divide."""
    size = len(next(iter(batch.values())))
    if size % world:
        raise ValueError(f"a batch of {size} does not split over {world} "
                         f"ranks")
    lo, hi = rank * size // world, (rank + 1) * size // world
    return {k: v[lo:hi] for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, group=None, src: int = 0):
    """Broadcast `src`'s parameters and buffers to every rank of the
    group, in place."""
    for t in [*module.parameters(), *module.buffers()]:
        dist.broadcast(t.data, src=src, group=group)
    return module


def serving_devices(n: int, device="cuda") -> list:
    """The devices of a sharded `run_batch`: the first n cards (raises when
    the host has fewer), or n times the CPU for device='cpu'.  The JAX
    package's make_mesh takes fewer devices without a word."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"{n} inference devices asked for, {have} CUDA "
                           f"devices present")
    return [torch.device("cuda", i) for i in range(n)]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
