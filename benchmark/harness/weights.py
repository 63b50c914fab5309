"""Seeded weights of a configuration, made on the device in two draws.

The rule of every entry (the port's chip_smoke.py `random_state_dict`):
BatchNorm running variance 0.5 + U[0, 1), running mean 0.05 N(0, 1),
scale 0.75 + 0.5 U[0, 1), every bias 0.05 N(0, 1), every convolution
kernel `conv_gain` N(0, 1) / sqrt(fan_in), the DCN offset/mask
convolutions at `offset_gain` instead.  The gains are the configuration's:
at DLA-34's conv gain the DCN offsets reach ~20 px on a 2048x1024 frame
and the random network turns chaotic (bf16 heads part from f32 by ~0.4
of their range), so its offset gain keeps them within ~12 px, past the
rowband:6 band at a few nodes."""
from __future__ import annotations

import math

import torch


def make(shapes, seed: int, conv_gain: float, offset_gain: float,
         device) -> dict:
    """{name: f32 tensor on `device`} for every floating entry of
    `shapes` ({name: (shape, is_float)}): one normal and one uniform draw
    from a generator on the device seeded with `seed`, cut in name order."""
    names = [k for k, (_, is_float) in shapes.items() if is_float]
    uniform = [k for k in names if k.endswith("running_var")
               or (len(shapes[k][0]) == 1 and k.endswith("weight")
                   and not k.endswith("running_mean"))]
    normal = [k for k in names if k not in uniform]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    numel = {k: math.prod(shapes[k][0]) for k in names}
    z = torch.randn(sum(numel[k] for k in normal), generator=gen,
                    device=device)
    u = torch.rand(sum(numel[k] for k in uniform), generator=gen,
                   device=device)
    out, zi, ui = {}, 0, 0
    for k in names:
        shape = shapes[k][0]
        n = numel[k]
        if k in uniform:
            a = u[ui:ui + n].view(shape)
            ui += n
            out[k] = 0.5 + a if k.endswith("running_var") else 0.75 + 0.5 * a
            continue
        a = z[zi:zi + n].view(shape)
        zi += n
        if len(shape) == 1:
            out[k] = 0.05 * a                  # running mean, biases
        else:
            gain = offset_gain if "conv_offset_mask" in k else conv_gain
            out[k] = a * (gain / math.sqrt(math.prod(shape[1:])))
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    """{name: (shape, is_float)} of a module's state_dict entries."""
    return {k: (tuple(v.shape), v.is_floating_point())
            for k, v in module.state_dict().items()}


def counters(shapes, device) -> dict:
    """The integer entries of `shapes` (BatchNorm's num_batches_tracked)
    at 0."""
    return {k: torch.zeros(s, dtype=torch.long, device=device)
            for k, (s, is_float) in shapes.items() if not is_float}
