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
