"""smallhourglass and Hourglass-104 polydet: the PyTorch port against the
JAX package, f32 on the CPU.

Weights: random JAX variables from `jax.eval_shape` (a flax init of
Hourglass-104 takes ~25 s on one CPU core), carried into the port by
weights.state_dict_from_jax.  At the default gain of 1.2 the full-width
heads at 128x256 reach |logit| ~300 through the ~100 convolutions of a
stack: large, but finite and far from losing signal, so the head tests
keep it.  The detector test uses gain 0.8 (heads within ~1.3): at 1.2 the
heat map's sigmoid is exactly 1.0 at many peaks, and the top-K order
between ties is arbitrary.

Tolerances: every head within 2e-3 relative max of JAX (the DLA-34
bound, tests/test_torch_dla.py; measured ~1e-5).  The 2-stack train-mode
loss and its gradients against JAX: see `test_two_stack_loss_and_grads`.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import HEADS, jax_hourglass_variables, rel_max

from centerpoly_tpu.configs import Config as JaxConfig
from centerpoly_tpu.infer import detector as jdet
from centerpoly_tpu.losses import PolydetLossConfig as JLossConfig
from centerpoly_tpu.losses import polydet_loss as jpolydet_loss
from centerpoly_tpu.train.checkpoint import flatten_params
from centerpoly_tpu.train.torch_import import import_state_dict
from centerpoly_tpu_torch import main as tmain
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (CityscapesMeta, CocoPolyAnnotations,
                                       Loader, PolydetSampler)
from centerpoly_tpu_torch.data.fixture import write_rect_fixture
from centerpoly_tpu_torch.infer.detector import create_detector
from centerpoly_tpu_torch.kernels import dcn
from centerpoly_tpu_torch.losses import PolydetLossConfig, polydet_loss
from centerpoly_tpu_torch.models import create_model
from centerpoly_tpu_torch.models.hourglass import HourglassNet
from centerpoly_tpu_torch.train.step import to_device
from centerpoly_tpu_torch.weights import load_weights, state_dict_from_jax

H, W = 128, 256     # the short side of an hourglass input is >= 128
# 2 stacks, narrow: the first level's residuals change width (256 -> 32),
# so their `skip` is built, and the inter-stack glue runs
NARROW = dict(dims=(32, 32, 48, 48, 48, 64), modules=(1, 1, 1, 1, 1, 2),
              head_conv=16)
LOSS = dict(rep="polar", poly_loss="l1+iou", poly_order=True)
# the keys a 1-stack net does not have
SECOND_STACK = ("kp_1", "cnv_1", "heads_1", "inter_0", "inter__0", "cnv__0")


def _first_stack(variables):
    """Hourglass-104's variables -> smallhourglass's: the first stack."""
    return {col: {k: v for k, v in tree.items() if k not in SECOND_STACK}
            for col, tree in variables.items()}


@pytest.fixture(scope="module")
def hourglass104():
    """Full-width Hourglass-104 variables (2 stacks, seed 1, gain 1.2)."""
    return jax_hourglass_variables(HEADS, H, W, seed=1, num_stacks=2)[1]


@pytest.fixture(scope="module")
def narrow():
    return jax_hourglass_variables(HEADS, H, W, seed=2, num_stacks=2,
                                   **NARROW)


def _input(b=1, seed=0):
    return np.random.RandomState(seed).randn(b, H, W, 3).astype(np.float32)


def _port(variables, arch, **kw):
    model = (HourglassNet(HEADS, 2, **kw) if kw
             else create_model(arch, HEADS, 256))
    load_weights(model, state_dict_from_jax(variables, arch), strict=True)
    return model.eval()


def _check_heads(ref_stacks, got_stacks):
    assert len(got_stacks) == len(ref_stacks)
    for s, (ref, got) in enumerate(zip(ref_stacks, got_stacks)):
        assert set(got) == set(HEADS)
        for head, r in ref.items():
            g = got[head].permute(0, 2, 3, 1).numpy()
            assert g.shape == r.shape
            assert np.isfinite(r).all()
            assert rel_max(g, r) < 2e-3, (s, head)


def test_smallhourglass_heads_match_jax(hourglass104):
    """(a) full width, 1 stack, every head at 128x256."""
    from centerpoly_tpu.models import create_model as jcreate_model
    variables = _first_stack(hourglass104)
    model = jcreate_model("smallhourglass", HEADS, 256)
    x = _input()
    ref = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    port = _port(variables, "smallhourglass")
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _check_heads(ref, got)


def test_two_stack_heads_match_jax(narrow):
    """(b) 2 stacks at narrow dims: every stack's heads."""
    model, variables = narrow
    x = _input()
    ref = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    port = _port(variables, "hourglass", **NARROW)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _check_heads(ref, got)


@pytest.mark.parametrize("arch", ["smallhourglass", "hourglass"])
def test_state_dict_round_trips_through_jax_import(hourglass104, arch):
    """(c) importing state_dict_from_jax's output with the JAX package's
    reference name map loads every leaf, skips nothing and gives every
    array back exactly."""
    variables = (_first_stack(hourglass104) if arch == "smallhourglass"
                 else hourglass104)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables,
                                                       arch).items()}
    zeros = jax.tree.map(np.zeros_like, variables)
    back, report = import_state_dict(sd, zeros, arch)
    assert report["skipped"] == []
    want = flatten_params(variables["params"])
    want.update(flatten_params(variables["batch_stats"]))
    got = flatten_params(back["params"])
    got.update(flatten_params(back["batch_stats"]))
    assert len(report["loaded"]) == len(want) == len(sd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch,stacks", [("smallhourglass", 1),
                                         ("hourglass", 2)])
def test_port_names_are_the_reference_names(hourglass104, arch, stacks):
    """(d) the port's own keys (BatchNorm's counter aside) are the carried
    keys, among them the inter-stack glue, a width-changing skip and the
    per-stack heads; a 2-stack JAX tree does not load as smallhourglass."""
    variables = (_first_stack(hourglass104) if arch == "smallhourglass"
                 else hourglass104)
    with torch.device("meta"):
        model = create_model(arch, HEADS, 64)
    own = {k for k in model.state_dict()
           if not k.endswith("num_batches_tracked")}
    assert set(state_dict_from_jax(variables, arch)) == own
    assert model.num_stacks == stacks and len(model.kps) == stacks
    assert "pre.1.skip.0.weight" in own and "hm.0.1.bias" in own
    assert "kps.0.low2.low2.low2.low2.low2.3.conv1.weight" in own
    assert "kps.0.low1.0.skip.0.weight" in own
    assert "kps.0.up1.0.skip.0.weight" not in own   # 256 -> 256, stride 1
    assert model.hm[0][0].conv.weight.shape[0] == 256  # head_conv ignored
    glue = {"inters_.0.0.weight", "cnvs_.0.1.running_var",
            "hm.1.0.conv.weight", "inters.0.conv1.weight"}
    assert glue <= own if stacks == 2 else not glue & own
    if stacks == 2:
        with pytest.raises(ValueError, match="2 stacks"):
            state_dict_from_jax(variables, "smallhourglass")


def test_hm_bias_init_and_no_dcn_node():
    model = HourglassNet(HEADS, 2, **NARROW)
    for s in range(2):
        assert torch.all(model.hm[s][1].bias == -2.19)
        assert torch.all(model.poly[s][1].bias == 0)
    from centerpoly_tpu_torch.models.deform_conv import DCNv2
    assert not any(isinstance(m, DCNv2) for m in model.modules())
    assert Config(arch="hourglass").num_stacks == 2
    assert Config(arch="smallhourglass").num_stacks == 1
    assert Config(arch="smallhourglass").pad == 127


@pytest.fixture(scope="module")
def fixture_batch(tmp_path_factory):
    """A batch of 2 from the port's sampler on a 256x512 rectangle
    fixture at 128x256 input (numpy, NHWC)."""
    root = write_rect_fixture(str(tmp_path_factory.mktemp("fx")), 2, 0,
                              2 * H, 2 * W)
    cfg = Config(arch="smallhourglass", input_h=H, input_w=W, **LOSS)
    meta = CityscapesMeta(root)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    batch = next(iter(Loader(sampler, 2, 2, shuffle=False)))
    assert batch["reg_mask"].sum() >= 2
    return batch


def _port_loss_grads(net, sd, batch, train, dtype=torch.float64,
                     perturb=False):
    """The port's polydet loss parts and parameter gradients (f64 on the
    host) for `sd` in `dtype`, BatchNorm in train mode or on its running
    statistics; `perturb` moves every parameter by a seeded relative
    1e-6 first."""
    net.load_state_dict(sd)
    net.to(dtype).train(train).zero_grad(set_to_none=True)
    if perturb:
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen,
                                              dtype=dtype))
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in batch.items()}
    outs = [{k: v.permute(0, 2, 3, 1) for k, v in o.items()}
            for o in net(b["input"])]
    assert len(outs) == 2
    loss, stats = polydet_loss(outs, b, PolydetLossConfig(**LOSS))
    loss.backward()
    return ({k: v.item() for k, v in stats.items()},
            {n: p.grad.double() for n, p in net.named_parameters()})


@pytest.mark.parametrize("train", [False, True])
def test_two_stack_loss_and_grads(narrow, fixture_batch, train):
    """(e) the polydet loss over both stacks and every parameter gradient
    against JAX's, f32, BatchNorm on its running statistics and in train
    mode (as a train step runs it).

    On running statistics the net is well-conditioned (measured: loss
    parts ~1e-5 relative, gradients <= 4e-4 relative L2): loss parts
    within 1e-4 relative, gradients within 2e-3 relative L2.  In train mode
    the random net is not: the port's own gradients move by up to ~50 %
    (relative L2) when every weight moves by a relative 1e-6, and f32
    parts from f64 by up to ~25 %; JAX and the port differ by as much.  So
    each loss part and gradient is held within 4x the port's own floor,
    the larger of those two moves (+1e-5 relative for a loss part, +1e-3
    for a gradient), as tests/test_torch_train.py does for DLA-34."""
    model, variables = narrow
    jbatch = {k: jnp.asarray(v) for k, v in fixture_batch.items()}

    @jax.jit
    def jloss(params):
        outs, _ = model.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              jbatch["input"], train=train,
                              mutable=["batch_stats"])
        return jpolydet_loss(outs, jbatch, JLossConfig(**LOSS))

    (_, jstats), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    # carried by the same name map (the running statistics only complete
    # the walk: gradients are compared for parameters)
    ref_grads = state_dict_from_jax(
        {"params": jgrads, "batch_stats": variables["batch_stats"]},
        "hourglass")
    net = _port(variables, "hourglass", **NARROW)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    batch = to_device(fixture_batch, "cpu")
    stats, grads = _port_loss_grads(net, sd, batch, train, torch.float32)
    assert set(grads) == {k for k in ref_grads if not k.endswith(
        ("running_mean", "running_var"))}
    if train:
        moved = [_port_loss_grads(net, sd, batch, train, torch.float32, True),
                 _port_loss_grads(net, sd, batch, train)]
        stat_floor = {k: max(abs(m[0][k] - stats[k]) for m in moved)
                      for k in stats}
        grad_floor = {n: max(float((m[1][n] - g).norm() / g.norm())
                             for m in moved) for n, g in grads.items()}
    for k in jstats:
        ref = float(jstats[k])
        tol = (4 * stat_floor[k] + 1e-5 * abs(ref) if train
               else 1e-4 * abs(ref))
        assert abs(stats[k] - ref) <= tol, (k, stats[k], ref)
    for name, g in grads.items():
        ref = ref_grads[name].double()
        err = float((g - ref).norm() / ref.norm())
        tol = 4 * grad_floor[name] + 1e-3 if train else 2e-3
        assert err <= tol, (name, err, tol)


@pytest.fixture(scope="module")
def detector_variables():
    """Full-width smallhourglass variables at gain 0.8 (see the module
    docstring)."""
    return jax_hourglass_variables(HEADS, H, W, seed=3, gain=0.8)[1]


def test_detector_matches_jax(monkeypatch, detector_variables):
    """(f) `create_detector(...).run` on a 128x256 frame against the JAX
    detector's detections, within test_torch_detector.py's bounds (scores
    and depth 1e-3, coordinates 1e-2 px); `run_batch` and `run_stream`
    give run()'s detections."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    monkeypatch.setattr(jdet.BaseDetector, "_shrink_for_send",
                        lambda self, image, trans, h, w: (image, trans))
    kw = dict(arch="smallhourglass", input_h=H, input_w=W, K=16,
              mixed_precision=False)
    frame = np.random.RandomState(11).randint(0, 256, (H, W, 3),
                                              dtype=np.uint8)
    ref = jdet.create_detector(JaxConfig(**kw), detector_variables).run(frame)
    JaxConfig(**kw)  # dcn_kernel auto: restores the variable's prior value
    before = dict(dcn.launches)
    port = create_detector(Config(**kw), detector_variables, device="cpu")
    got = port.run(frame)
    n = 0
    for j in range(1, 9):
        g = np.asarray(got["results"][j])
        r = np.asarray(ref["results"][j])
        assert g.shape == r.shape, j
        n += len(r)
        np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, :4], r[:, :4], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 5:-1], r[:, 5:-1], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, -1], r[:, -1], rtol=0, atol=1e-3)
    assert n == 16
    batch = port.run_batch([frame, frame[::-1].copy()])
    (streamed,) = port.run_stream(iter([frame]), depth=2)
    for j in range(1, 9):
        np.testing.assert_allclose(batch[0]["results"][j], got["results"][j],
                                   rtol=0, atol=1e-2)
        np.testing.assert_array_equal(streamed[j], got["results"][j])
    assert dcn.launches == before


def test_main_trains_and_resumes(tmp_path):
    """(g) `main --arch smallhourglass` at full width on the CPU: one
    epoch of 1 step (batch 2, 128x256) and a val pass, then --resume to
    epoch 2; `head_conv` and `dcn_kernel` are accepted and change
    nothing."""
    root = write_rect_fixture(str(tmp_path), 2, 1, 2 * H, 2 * W,
                              splits=("train", "val"))
    args = ["polydet", "--arch", "smallhourglass", "--data_dir", root,
            "--save_dir", str(tmp_path / "exp"), "--input_h", str(H),
            "--input_w", str(W), "--head_conv", "16", "--dcn_kernel",
            "halo:4", "--batch_size", "2", "--num_workers", "0",
            "--val_intervals", "1", "--device", "cpu", "--rep", "polar",
            "--poly_loss", "l1+iou", "--poly_order"]
    trainer = tmain.main(args + ["--num_epochs", "1"])
    assert trainer.state.step == 1 and trainer.cfg.num_stacks == 1
    model = trainer.state.model
    assert isinstance(model, HourglassNet) and model.num_stacks == 1
    assert model.hm[0][0].conv.weight.shape[0] == 256
    save_dir = tmp_path / "exp" / "cityscapes" / "polydet" / "default"
    assert (save_dir / "model_last.pth").exists()
    assert (save_dir / "model_best.pth").exists()
    resumed = tmain.main(args + ["--num_epochs", "2", "--resume"])
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    logs = [os.path.join(d, f) for d, _, fs in os.walk(save_dir) for f in fs
            if f in ("log.txt", "scalars.jsonl")]
    text = "".join(open(p).read() for p in logs if p.endswith("log.txt"))
    assert "model smallhourglass" in text and "resumed from epoch 1" in text
    losses = [json.loads(line)["value"] for p in logs
              if p.endswith("scalars.jsonl") for line in open(p)
              if json.loads(line)["tag"] == "train_loss"]
    assert losses and np.isfinite(losses).all()


def test_demo_smallhourglass(tmp_path, capsys, monkeypatch):
    """The image demo with `--arch smallhourglass` builds the 1-stack net,
    runs it and writes its overlay."""
    cv2 = pytest.importorskip("cv2")
    cv2.imwrite(str(tmp_path / "a.png"), np.random.RandomState(0).randint(
        0, 256, (H, W, 3), dtype=np.uint8))
    from centerpoly_tpu_torch.infer import demo
    from centerpoly_tpu_torch.infer import detector as detector_module
    made = []

    def spy(cfg, *args, **kw):
        made.append(create_detector(cfg, *args, **kw))
        return made[-1]

    monkeypatch.setattr(detector_module, "create_detector", spy)
    demo.main(["polydet", "--arch", "smallhourglass", "--demo",
               str(tmp_path / "a.png"), "--device", "cpu", "--input_h",
               str(H), "--input_w", str(W), "--save_overlay"])
    assert "a.png: tot" in capsys.readouterr().out
    assert (tmp_path / "a_polydet.png").exists()
    (det,) = made
    assert isinstance(det.model, HourglassNet) and det.model.num_stacks == 1
