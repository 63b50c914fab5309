"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same weights: random JAX variables made with numpy
from a seed (every leaf non-degenerate, so head outputs carry signal
through the 30+ layers and the DCN offsets are non-zero), carried into the
port by centerpoly_tpu_torch.weights.state_dict_from_jax.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import jax
import jax.numpy as jnp


def share_cores() -> int:
    """Cap torch's intra-op threads at this process's share of the cores.

    Each pytest-xdist worker's torch would otherwise start one OpenMP
    thread a core, so six workers keep 48 spinning threads (beside XLA's
    pools) on 8 cores, and a port test that takes 27 s alone takes over
    600 s in the suite.  Every test_torch_* module imports this module,
    so the cap holds in every worker before its first test."""
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, cores // workers)
    torch.set_num_threads(n)
    return n


share_cores()


@contextlib.contextmanager
def threads(n: int):
    """torch on `n` threads inside the block: a train step's f32 result
    depends on the thread count (oneDNN splits its sums by thread), so a
    comparison with a data-parallel rank (one thread) runs in its
    arithmetic."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


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
    return jax_variables("dla_34", heads, head_conv, h, w, seed, offset_gain)


def jax_variables(arch: str, heads, head_conv: int, h: int, w: int,
                  seed: int, offset_gain: float = 1.0, gain: float = 1.2):
    """(flax model of `arch` from the JAX registry, random variables) for
    an (h, w) input."""
    from centerpoly_tpu.models import create_model

    model = create_model(arch, heads, head_conv)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, h, w, 3)), train=False))
    return model, randomize_variables(shapes, seed, offset_gain, gain)


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


def port_model(variables, heads, head_conv: int, dcn_kernel: str = "auto",
               arch: str = "dla_34"):
    """The port's model of `arch` with the JAX variables loaded (f32, CPU,
    eval)."""
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.weights import load_weights, state_dict_from_jax

    model = create_model(arch, heads, head_conv, dcn_kernel=dcn_kernel)
    load_weights(model, state_dict_from_jax(variables, arch), strict=True)
    return model.eval()


def self_sensitivity(net, batch, loss_cfg, loss_fn=None):
    """How far the port's own loss parts and gradients move when every
    weight moves by a relative 1e-6 (seeded): the conditioning of the
    random network, the floor under any comparison of two
    implementations.  `batch` is one batch, or a list of batches whose
    gradients are averaged (the bucketed data-parallel step's rule:
    BatchNorm and losses per batch).  Returns ({stat: |change|},
    {parameter: relative L2 change of its gradient}, {BatchNorm
    statistic: max |change|}); parameters whose exact gradient is 0 (DCN
    biases feeding train-mode BatchNorm) or that no path reads are left
    out.  `loss_fn`: the task's loss, polydet_loss by default."""
    import torch

    from centerpoly_tpu_torch.losses import polydet_loss

    from centerpoly_tpu_torch.models.deform_conv import DCNv2

    loss_fn = loss_fn or polydet_loss
    batches = batch if isinstance(batch, list) else [batch]
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    # every DCNv2 node of DLA-34 and resdcn feeds a train-mode BatchNorm,
    # which removes its bias: that gradient is 0 but for rounding
    dcn_biases = {f"{name}.bias" for name, m in net.named_modules()
                  if isinstance(m, DCNv2)}

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
            loss, parts = loss_fn(out, b, loss_cfg)
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
             if n not in dcn_biases},
            {n: float((b1[n] - b0[n]).abs().max()) for n in b0})


def f64(tree):
    """A tree of arrays with every floating leaf as f64 numpy."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
        else np.asarray(a), tree)


def jax_step_f64(arch, heads, head_conv: int, hw, lr: float, loss_kw,
                 variables, batch, task: str = "polydet"):
    """One step of the JAX package's train step in f64 (the model of
    `arch` built with dtype float64 under jax.enable_x64) from `variables`
    on the host `batch`: (its stats, its gradients, and its parameters
    and BatchNorm statistics after the step), the last two as port
    state_dicts; `task`'s loss (polydet, ctdet, exdet, multi_pose or ddd) with
    `loss_kw`.  The DCN mode is CENTERPOLY_PALLAS_DCN's as the step is
    traced."""
    from centerpoly_tpu.losses import CtdetLossConfig, PolydetLossConfig
    from centerpoly_tpu.losses.ddd import DddLossConfig
    from centerpoly_tpu.losses.exdet import ExdetLossConfig
    from centerpoly_tpu.losses.multi_pose import MultiPoseLossConfig
    from centerpoly_tpu.models import create_model
    from centerpoly_tpu.train import state as jstate
    from centerpoly_tpu.train.step import loss_fn_for_task, make_train_step
    from centerpoly_tpu_torch.weights import state_dict_from_jax

    variables, batch = f64(variables), f64(batch)
    with jax.enable_x64(True):
        model = create_model(arch, heads, head_conv, dtype=jnp.float64)
        st = jstate.create_train_state(model, jax.random.PRNGKey(0),
                                       (1, *hw, 3), base_lr=lr,
                                       fast_init=True)
        params = jax.tree.map(jnp.asarray, variables["params"])
        st = st.replace(params=params, opt_state=st.tx.init(params),
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]))
        loss_cfg = {"polydet": PolydetLossConfig, "ctdet": CtdetLossConfig,
                    "exdet": ExdetLossConfig,
                    "multi_pose": MultiPoseLossConfig,
                    "ddd": DddLossConfig}[task](**loss_kw)
        st, stats = make_train_step(
            loss_cfg, loss_callable=loss_fn_for_task(task))(
            st, jax.tree.map(jnp.asarray, batch))
        assert jax.tree.leaves(st.params)[0].dtype == jnp.float64
        # Adam's first moment after one step is (1 - b1) g
        mu = jax.tree.map(lambda m: np.asarray(m) / 0.1,
                          st.opt_state[0][0].mu)
        after = jax.tree.map(np.asarray, {"params": st.params,
                                          "batch_stats": st.batch_stats})
        stats = {k: float(v) for k, v in stats.items()}
    return (stats, state_dict_from_jax({"params": mu}, arch),
            state_dict_from_jax(after, arch))


def port_batch_f64(batch):
    """A host batch as the port's step takes it, in f64 (train/step.py's
    to_device casts to f32)."""
    out = {k: torch.as_tensor(v) for k, v in f64(
        {k: v for k, v in batch.items() if k != "meta"}).items()}
    out["input"] = out["input"].permute(0, 3, 1, 2)
    return out
