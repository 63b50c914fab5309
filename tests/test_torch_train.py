"""Training path of the PyTorch port against the JAX package.

* lr_schedule, the global-norm clip and Adam against optax;
* BatchNorm's running variance (biased, as flax) after one update;
* one DLA-34 polydet train step at 64x128, batch 2, from the same weights
  on the same batch, with the DCN offset convs at zero (offsets exactly 0:
  every sample at an integer position, the init of training) and at gain
  1, and in halo:2: loss, every gradient, the parameters after Adam and
  the BatchNorm statistics;
* checkpoints and `main` on a fixture.

The train steps run in f64 on both sides (torch_port_common.jax_step_f64,
port_batch_f64), as tests/test_torch_resnet_train.py's: in f32 the port's
result moves with torch's thread count (oneDNN splits sums by thread) by
as much as the gradient bound below, and flax's f32 BatchNorm variance
(E[x^2] - E[x]^2) moves JAX's by as much (measured on resdcn_18, that
file).  Tolerances: parameters after Adam atol 2*lr (+1e-6, the f32
rounding of the weight itself, and of the heads the port's step rounds to
f32): Adam's first step moves each weight by ~lr*sign(g), so a gradient
near 0 whose sign differs between the two moves a weight by up to 2*lr;
BatchNorm statistics rtol 1e-4, atol 1e-5 + 4x their measured floor.

The random network is ill-conditioned: when every weight moves by a
relative 1e-6, the port's own gradients move by 1-3 % (relative L2), and
at offset gain 1 its loss by ~5e-4 and the depth loss by 1 %.  So the
test measures that floor (`torch_port_common.self_sensitivity`, in f64)
and holds each loss part to 4x it (+1e-5 relative), each gradient, in
relative L2, to 4x it (+1e-3), and the BatchNorm statistics as above.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_common import (HEADS, f64, jax_dla_variables, jax_step_f64,
                               port_batch_f64, port_model, self_sensitivity)

from centerpoly_tpu.models import layers as jlayers
from centerpoly_tpu.train import state as jstate
from centerpoly_tpu_torch import main as tmain
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (CityscapesMeta, CocoPolyAnnotations,
                                       Loader, PolydetSampler)
from centerpoly_tpu_torch.data.fixture import write_rect_fixture
from centerpoly_tpu_torch.losses import PolydetLossConfig
from centerpoly_tpu_torch.models.layers import BatchNorm2d
from centerpoly_tpu_torch.train import checkpoint, state as tstate
from centerpoly_tpu_torch.train.step import make_train_step

H, W, HEAD_CONV, LR = 64, 128, 32, 2e-4
LOSS = dict(rep="polar", poly_loss="l1+iou", poly_order=True)


# -- optimizer pieces --------------------------------------------------------

def test_lr_schedule_matches_optax():
    ref = jstate.lr_schedule(1e-3, (2, 5), 7)
    got = tstate.lr_schedule(1e-3, (2, 5), 7)
    for count in (0, 1, 13, 14, 15, 34, 35, 36, 100):
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_adam_with_clip_matches_optax(max_norm):
    """Five steps of Adam (with the step decay after 2 and the global-norm
    clip) on two tensors, against optax's chain."""
    rng = np.random.RandomState(0)
    p0 = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*a.shape).astype(np.float32) for a in p0]
             for _ in range(5)]
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adam(jstate.lr_schedule(1e-2, (2,), 1)))
    jp = [jnp.asarray(a) for a in p0]
    opt = tx.init(jp)
    model = torch.nn.ParameterList([torch.nn.Parameter(torch.tensor(a))
                                    for a in p0])
    st = tstate.create_train_state(model, 1e-2, (2,), 1, grad_clip=max_norm)
    for g in grads:
        upd, opt = tx.update([jnp.asarray(a) for a in g], opt, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(model, g):
            p.grad = torch.tensor(a)
        st.apply_gradients()
    for p, a in zip(model, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-7)
    assert st.step == 5


def test_batchnorm_tracks_biased_variance_like_flax():
    import flax.linen as fnn
    x = np.random.RandomState(0).randn(8, 3, 2, 2).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False,
                            momentum=jlayers.BN_MOMENTUM)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    variables = flax_bn.init(jax.random.PRNGKey(0), xj)
    yj, upd = flax_bn.apply(variables, xj, mutable=["batch_stats"])
    bn = BatchNorm2d(3).train()
    y = bn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    unbiased = torch.nn.BatchNorm2d(3).train()
    unbiased(torch.from_numpy(x))
    assert not torch.allclose(unbiased.running_var, bn.running_var)


# -- one DLA-34 train step ---------------------------------------------------

@pytest.fixture(scope="module")
def fixture_batch(tmp_path_factory):
    """A batch of 2 from the port's sampler on a 128x256 rectangle
    fixture (numpy, NHWC)."""
    root = write_rect_fixture(str(tmp_path_factory.mktemp("fx")), 2, 0,
                              2 * H, 2 * W)
    cfg = Config(input_h=H, input_w=W, head_conv=HEAD_CONV, **LOSS)
    meta = CityscapesMeta(root)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    batch = next(iter(Loader(sampler, 2, 2, shuffle=False)))
    assert batch["reg_mask"].sum() >= 2
    return batch


def _zero_offset_convs(variables):
    """Offset convs at zero (kernel and bias): the DCNv2 init."""
    def zero(path, a):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        return np.zeros_like(a) if "conv_offset_mask" in name else a
    return jax.tree_util.tree_map_with_path(zero, variables)


@pytest.mark.parametrize("offset_gain", [0.0, 1.0])
def test_train_step_matches_jax(monkeypatch, fixture_batch, offset_gain):
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    _, variables = jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=2,
                                     offset_gain=offset_gain)
    if offset_gain == 0.0:
        variables = _zero_offset_convs(variables)
    _check_train_step(variables, fixture_batch)


def test_train_step_matches_jax_halo(monkeypatch, fixture_batch):
    """halo:2 at offset gain 1, so many offsets lie beyond R on both axes.
    The JAX step runs the flax layers' clipped XLA path on the CPU
    (deform_conv.py:1012); random offsets land on exactly +-R with
    probability 0, where its tie rule and the port's differ.  The env
    var is set through monkeypatch, and the JAX step is made afresh: the
    mode is read when the step is traced."""
    monkeypatch.setenv("CENTERPOLY_PALLAS_DCN", "halo:2")
    _, variables = jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=2)
    _check_train_step(variables, fixture_batch, dcn_kernel="halo:2")


def _check_train_step(variables, fixture_batch, dcn_kernel="auto"):
    """One step of each package in f64 (torch_port_common.jax_step_f64;
    the port's net and batch in f64) from `variables` on the batch."""
    variables = f64(variables)
    jstats, jgrads, jafter = jax_step_f64("dla_34", HEADS, HEAD_CONV, (H, W),
                                          LR, LOSS, variables, fixture_batch)

    net = port_model(variables, HEADS, HEAD_CONV,
                     dcn_kernel=dcn_kernel).double()
    batch = port_batch_f64(fixture_batch)
    stat_floor, grad_floor, buf_floor = self_sensitivity(
        net, batch, PolydetLossConfig(**LOSS))
    st = tstate.create_train_state(net, base_lr=LR)
    st, stats = make_train_step(PolydetLossConfig(**LOSS))(st, batch)
    for k, ref in jstats.items():
        assert abs(float(stats[k]) - ref) <= 4 * stat_floor[k] + 1e-5 * abs(
            ref), (k, float(stats[k]), ref, stat_floor[k])
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jafter[name].numpy(),
                                   rtol=0, atol=2 * LR + 1e-6, err_msg=name)
        if name not in grad_floor:
            continue
        ref = jgrads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / np.linalg.norm(ref)
        assert err <= 4 * grad_floor[name] + 1e-3, (name, err,
                                                    grad_floor[name])
    # every DCN offset conv received a gradient, and it was compared
    assert sum("conv_offset_mask" in n for n in grad_floor) == 32
    for name, floor in buf_floor.items():
        np.testing.assert_allclose(
            net.get_buffer(name).numpy(), jafter[name].numpy(), rtol=1e-4,
            atol=4 * floor + 1e-5, err_msg=name)


# -- checkpoints and main ----------------------------------------------------

def _tiny_state():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), BatchNorm2d(4))
    st = tstate.create_train_state(net, base_lr=1e-3)
    net(torch.randn(2, 3, 5, 5)).sum().backward()
    st.apply_gradients()
    return st


def test_checkpoint_round_trip(tmp_path):
    st = _tiny_state()
    path = checkpoint.save_checkpoint(str(tmp_path), "last", st, 7)
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) >= {"epoch", "state_dict", "optimizer"}
    fresh = tstate.create_train_state(
        torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), BatchNorm2d(4)), 1e-3)
    fresh, epoch, report = checkpoint.load_checkpoint(str(tmp_path), "last",
                                                      fresh)
    assert epoch == 7 and fresh.step == 1 and not report["skipped"]
    for k, v in st.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v)
    a, b = st.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i in a["state"]:
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(b["state"][i][k], a["state"][i][k])


def test_checkpoint_strips_module_prefix_and_skips_mismatch(tmp_path):
    st = _tiny_state()
    sd = {f"module.{k}": v for k, v in st.model.state_dict().items()}
    sd["module.0.weight"] = torch.zeros(2, 2)          # wrong shape: skipped
    torch.save({"epoch": 3, "state_dict": sd}, str(tmp_path / "model_x.pth"))
    fresh = _tiny_state()
    fresh, epoch, report = checkpoint.load_checkpoint(str(tmp_path), "x",
                                                      fresh)
    assert epoch == 3 and report["skipped"] == ["0.weight"]
    torch.testing.assert_close(fresh.model[0].bias, st.model[0].bias)


def test_main_trains_and_resumes_on_a_fixture(tmp_path):
    """`main` for one epoch of 2 steps, then --resume to epoch 2."""
    root = write_rect_fixture(str(tmp_path), 4, 1, 128, 256,
                              splits=("train", "val"))
    args = ["polydet", "--data_dir", root, "--save_dir", str(tmp_path / "exp"),
            "--input_h", "64", "--input_w", "128", "--head_conv", "16",
            "--batch_size", "2", "--num_workers", "0", "--val_intervals", "1",
            "--rep", "polar", "--poly_loss", "l1+iou", "--poly_order",
            "--dcn_kernel", "rowband:4", "--device", "cpu"]
    trainer = tmain.main(args + ["--num_epochs", "1"])
    assert trainer.state.step == 2
    save_dir = tmp_path / "exp" / "cityscapes" / "polydet" / "default"
    assert (save_dir / "model_last.pth").exists()
    assert (save_dir / "model_best.pth").exists()
    resumed = tmain.main(args + ["--num_epochs", "2", "--resume"])
    assert resumed.start_epoch == 1 and resumed.state.step == 4
    logs = [os.path.join(d, f) for d, _, fs in os.walk(save_dir) for f in fs
            if f == "log.txt"]
    text = "".join(open(p).read() for p in logs)
    assert "resumed from epoch 1" in text and "epoch 2 | 2 iters" in text


def test_main_halo_on_a_fixture(tmp_path):
    """`main --dcn_kernel halo:4` for one epoch of 2 steps: every DCN node
    of the trained model clamps both axes, and the loss is finite."""
    root = write_rect_fixture(str(tmp_path), 4, 1, 128, 256,
                              splits=("train", "val"))
    trainer = tmain.main([
        "polydet", "--data_dir", root, "--save_dir", str(tmp_path / "exp"),
        "--input_h", "64", "--input_w", "128", "--head_conv", "16",
        "--batch_size", "2", "--num_workers", "0", "--val_intervals", "1",
        "--rep", "polar", "--poly_loss", "l1+iou", "--poly_order",
        "--dcn_kernel", "halo:4", "--device", "cpu", "--num_epochs", "1"])
    assert trainer.state.step == 2 and trainer.cfg.dcn_kernel == "halo:4"
    clamps = [m.clamp for m in trainer.state.model.modules()
              if hasattr(m, "clamp")]
    assert clamps == [{"max_offset": 4}] * 16
    save_dir = tmp_path / "exp" / "cityscapes" / "polydet" / "default"
    scalars = [json.loads(line) for d, _, fs in os.walk(save_dir)
               for f in fs if f == "scalars.jsonl"
               for line in open(os.path.join(d, f))]
    losses = [s["value"] for s in scalars if s["tag"] == "train_loss"]
    assert len(losses) == 1 and np.isfinite(losses[0])
