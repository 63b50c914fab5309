"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same weights: random JAX variables made with numpy
from a seed (every leaf non-degenerate, so head outputs carry signal
through the 30+ layers and the DCN offsets are non-zero), carried into the
port by centerpoly_tpu_torch.weights.state_dict_from_jax.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

HEADS = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}


def rel_max(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|)."""
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / scale)


def randomize_variables(shapes, seed: int, offset_gain: float = 1.0,
                        gain: float = 1.2):
    """Random numpy arrays for a tree of JAX shapes (from jax.eval_shape of
    a flax init).  `offset_gain` scales the DCN offset/mask convs: at 1.0
    their offsets come out a few pixels wide; `gain` scales every other
    conv kernel (times 1 / sqrt(fan_in))."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        shape = s.shape
        if name.endswith("var"):
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if name.endswith("mean"):
            return (0.05 * rng.randn(*shape)).astype(np.float32)
        if name.endswith("scale"):
            return (0.75 + 0.5 * rng.rand(*shape)).astype(np.float32)
        if name.endswith("bias"):
            return (0.05 * rng.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) or 1
        g = offset_gain if "conv_offset_mask" in name else gain
        return (rng.randn(*shape) * g / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_dla_variables(heads, head_conv: int, h: int, w: int, seed: int,
                      offset_gain: float = 1.0):
    """(flax DLASeg, random variables) for an (h, w) input."""
    from centerpoly_tpu.models import create_model

    model = create_model("dla_34", heads, head_conv)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, h, w, 3)), train=False))
    return model, randomize_variables(shapes, seed, offset_gain)


def jax_hourglass_variables(heads, h: int, w: int, seed: int,
                            num_stacks: int = 1, gain: float = 1.2, **kw):
    """(flax HourglassNet, random variables) for an (h, w) input, from
    jax.eval_shape (a real init of Hourglass-104 takes ~25 s on one CPU
    core).  `kw`: the module's dims, modules and head_conv."""
    from centerpoly_tpu.models.hourglass import HourglassNet

    model = HourglassNet(heads=heads, num_stacks=num_stacks, **kw)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, h, w, 3)), train=False))
    return model, randomize_variables(shapes, seed, gain=gain)


def port_model(variables, heads, head_conv: int, dcn_kernel: str = "auto"):
    """The port's DLASeg with the JAX variables loaded (f32, CPU, eval)."""
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.weights import load_weights, state_dict_from_jax

    model = create_model("dla_34", heads, head_conv, dcn_kernel=dcn_kernel)
    load_weights(model, state_dict_from_jax(variables), strict=True)
    return model.eval()


def self_sensitivity(net, batch, loss_cfg):
    """How far the port's own loss parts and gradients move when every
    weight moves by a relative 1e-6 (seeded): the conditioning of the
    random network, the floor under any comparison of two
    implementations.  `batch` is one batch, or a list of batches whose
    gradients are averaged (the bucketed data-parallel step's rule:
    BatchNorm and losses per batch).  Returns ({stat: |change|},
    {parameter: relative L2 change of its gradient}, {BatchNorm
    statistic: max |change|}); parameters whose exact gradient is 0 (DCN
    biases feeding train-mode BatchNorm) or that no path reads are left
    out."""
    import torch

    from centerpoly_tpu_torch.losses import polydet_loss

    batches = batch if isinstance(batch, list) else [batch]
    sd = {k: v.clone() for k, v in net.state_dict().items()}

    def run(gen=None):
        net.load_state_dict(sd)
        if gen is not None:
            with torch.no_grad():
                for p in net.parameters():
                    p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen))
        net.train().zero_grad(set_to_none=True)
        stats = {}
        for b in batches:
            out = [{k: v.permute(0, 2, 3, 1) for k, v in o.items()}
                   for o in net(b["input"])]
            loss, parts = polydet_loss(out, b, loss_cfg)
            (loss / len(batches)).backward()
            for k, v in parts.items():
                stats[k] = stats.get(k, 0.0) + float(v) / len(batches)
        return (stats,
                {n: p.grad.clone() for n, p in net.named_parameters()
                 if p.grad is not None},
                {n: b.clone() for n, b in net.named_buffers()
                 if n.endswith(("running_mean", "running_var"))})

    s0, g0, b0 = run()
    s1, g1, b1 = run(torch.Generator().manual_seed(0))
    net.load_state_dict(sd)
    net.zero_grad(set_to_none=True)
    return ({k: abs(s1[k] - s0[k]) for k in s0},
            {n: float((g1[n] - g0[n]).norm() / g0[n].norm()) for n in g0
             if not (".conv.bias" in n and "ida" in n)},
            {n: float((b1[n] - b0[n]).abs().max()) for n in b0})
