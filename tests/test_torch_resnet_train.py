"""resdcn_18 of the PyTorch port against the JAX package: one train step
and the detector; and the entry points (`main`, `test.py`, the demo) on
the new archs.

The train step: resdcn_18 at 64x128, batch 2 from the port's sampler on
a rectangle fixture, the v2 loss (polar, L1 + IoU, vertex order), one
Adam step from the same weights, in `off` (exact DCN) and in halo:2 (both
offset axes clamped; random offsets at gain 1 pass +-2 often on the 2x4
to 8x16 maps).  Both packages run it in f64.  In f32 the random network
is too ill-conditioned in train mode for a comparison: flax's BatchNorm
takes the variance as E[x^2] - E[x]^2 in f32, which leaves JAX's
gradient of a BatchNorm scale 1.2e-3 (relative L2) off its own f64
value, 16x the port's f32 distance to f64 and above the 4x-floor bound
of tests/test_torch_train.py (measured on deconv_layers.16.weight); and
the port's f32 result moves with its thread count (oneDNN splits sums by
thread).  In f64 the two agree to ~1e-7 but where the loss is not smooth (the
polygon loss sorts vertices by angle, so a head's f32 rounding in the
port's step, train/step.py, can flip an order): each loss part, each
gradient (relative L2) and each BatchNorm statistic is held to 4x the
port's own move under a seeded 1e-6 relative weight change
(`torch_port_common.self_sensitivity`, in f64) + 1e-6 relative (the
JAX values reach the port as f32 through state_dict_from_jax, and the
port's step rounds its heads to f32); that is the bound of
tests/test_torch_train.py with 1e-6 in place of its f32 slack; the parameters after
Adam within 2 lr + 1e-6, as in tests/test_torch_train.py (Adam's first
step moves a weight by ~lr sign(g), and the port rounds its heads to f32
before the loss, train/step.py, so a gradient within ~1e-7 of 0 can
take either sign).  The detector: per-class detections within 1e-3 in score
and 1e-2 px, as tests/test_torch_detector.py.
"""
import numpy as np
import pytest
import torch

from torch_port_common import (f64, jax_step_f64, jax_variables,
                               port_batch_f64, port_model, self_sensitivity)

from centerpoly_tpu.configs import Config as JaxConfig
from centerpoly_tpu.infer import detector as jdet
from centerpoly_tpu_torch import main as tmain
from centerpoly_tpu_torch import test as ttest
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (CityscapesMeta, CocoPolyAnnotations,
                                       Loader, PolydetSampler)
from centerpoly_tpu_torch.data.fixture import write_rect_fixture
from centerpoly_tpu_torch.infer.detector import create_detector
from centerpoly_tpu_torch.losses import PolydetLossConfig
from centerpoly_tpu_torch.models.resnet import ResNetDet
from centerpoly_tpu_torch.train import state as tstate
from centerpoly_tpu_torch.train.step import make_train_step

ARCH = "resdcn_18"
H, W, HEAD_CONV, LR = 64, 128, 16, 2e-4
HEADS = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
LOSS = dict(rep="polar", poly_loss="l1+iou", poly_order=True)


@pytest.fixture(scope="module")
def fixture_batch(tmp_path_factory):
    """A batch of 2 from the port's sampler on a 128x256 rectangle
    fixture (numpy, NHWC)."""
    root = write_rect_fixture(str(tmp_path_factory.mktemp("fx")), 2, 0,
                              2 * H, 2 * W)
    cfg = Config(arch=ARCH, input_h=H, input_w=W, head_conv=HEAD_CONV, **LOSS)
    meta = CityscapesMeta(root)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    batch = next(iter(Loader(sampler, 2, 2, shuffle=False)))
    assert batch["reg_mask"].sum() >= 2
    return batch


@pytest.mark.parametrize("mode", ["off", "halo:2"])
def test_train_step_matches_jax(monkeypatch, fixture_batch, mode):
    """One step of each package in f64 (the JAX model built with dtype
    float64 under jax.enable_x64; the port's net and batch in f64), from
    the same weights on the same batch.  The JAX step in halo:2 runs the
    flax layer's clipped XLA path on the CPU (CENTERPOLY_PALLAS_DCN, read
    when the step is traced)."""
    if mode == "off":
        monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    else:
        monkeypatch.setenv("CENTERPOLY_PALLAS_DCN", mode)
    variables = f64(jax_variables(ARCH, HEADS, HEAD_CONV, H, W, seed=2)[1])
    jstats, jgrads, jafter = jax_step_f64(ARCH, HEADS, HEAD_CONV, (H, W), LR,
                                          LOSS, variables, fixture_batch)

    net = port_model(variables, HEADS, HEAD_CONV, dcn_kernel=mode,
                     arch=ARCH).double()
    batch = port_batch_f64(fixture_batch)
    stat_floor, grad_floor, buf_floor = self_sensitivity(
        net, batch, PolydetLossConfig(**LOSS))
    st = tstate.create_train_state(net, base_lr=LR)
    st, stats = make_train_step(PolydetLossConfig(**LOSS))(st, batch)
    for k, ref in jstats.items():
        assert abs(float(stats[k]) - ref) <= 4 * stat_floor[k] + 1e-6 * abs(
            ref), (
            k, float(stats[k]), ref, stat_floor[k])
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jafter[name].numpy(),
                                   rtol=0, atol=2 * LR + 1e-6, err_msg=name)
        if name not in grad_floor:
            continue
        ref = jgrads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / np.linalg.norm(ref)
        assert err <= 4 * grad_floor[name] + 1e-6, (name, err,
                                                    grad_floor[name])
    # the 3 DCN offset convs received gradients, and they were compared
    assert sum("conv_offset_mask" in n for n in grad_floor) == 6
    assert len(buf_floor) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                                     for m in net.modules())
    for name, floor in buf_floor.items():
        np.testing.assert_allclose(net.get_buffer(name).numpy(),
                                   jafter[name].numpy(), rtol=1e-6,
                                   atol=4 * floor,
                                   err_msg=name)


@pytest.fixture
def jax_env(monkeypatch):
    """Start with CENTERPOLY_PALLAS_DCN unset (the JAX Config writes it);
    the JAX detector's host pre-shrink (cv2) is the identity, so both
    sides warp the same full frame."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    monkeypatch.setattr(jdet.BaseDetector, "_shrink_for_send",
                        lambda self, image, trans, h, w: (image, trans))
    yield
    JaxConfig(input_h=H, input_w=W)  # restores the variable's prior value


def test_detector_matches_jax(jax_env):
    """`run` on resdcn_18 in the inference default (rowband:6) against the
    JAX detector: the same 16 detections."""
    kw = dict(arch=ARCH, input_h=H, input_w=W, head_conv=HEAD_CONV, K=16,
              mixed_precision=False)
    variables = jax_variables(ARCH, HEADS, HEAD_CONV, H, W, seed=8,
                              offset_gain=0.3)[1]
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    assert jcfg.prefer_fast_inference_dcn() and cfg.prefer_fast_inference_dcn()
    assert cfg.dcn_kernel == jcfg.dcn_kernel == "rowband:6"
    frame = np.random.RandomState(11).randint(0, 256, (2 * H, 2 * W, 3),
                                              dtype=np.uint8)
    ref = jdet.create_detector(jcfg, variables).run(frame)["results"]
    det = create_detector(cfg, variables, device="cpu")
    assert isinstance(det.model, ResNetDet)
    got = det.run(frame)["results"]
    n = 0
    for j in range(1, 9):
        g, r = np.asarray(got[j]), np.asarray(ref[j])
        assert g.shape == r.shape, j
        n += len(r)
        np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(np.delete(g, 4, 1), np.delete(r, 4, 1),
                                   rtol=0, atol=1e-2)
    assert n == 16


def test_main_and_test_cli_on_the_new_archs(tmp_path, monkeypatch):
    """`main --arch resdcn_18` (rowband:4) and `--arch res_18` train an
    epoch of one step and write their checkpoints; `test.py --arch
    res_18` evaluates the latter on a PNG fixture and reaches an AP."""
    monkeypatch.setattr(CityscapesMeta, "eval_image_size", (128, 256))
    root = write_rect_fixture(str(tmp_path / "fx"), 2, 1, 128, 256,
                              splits=("train", "val"), png=True)
    common = ["polydet", "--data_dir", root, "--input_h", str(H),
              "--input_w", str(W), "--head_conv", str(HEAD_CONV),
              "--batch_size", "2", "--num_workers", "0", "--num_epochs", "1",
              "--K", "8", "--device", "cpu"]
    for arch, kernel in (("resdcn_18", "rowband:4"), ("res_18", "off")):
        save = tmp_path / arch
        tr = tmain.main(common + ["--arch", arch, "--dcn_kernel", kernel,
                                  "--save_dir", str(save)])
        assert tr.state.step == 1 and tr.cfg.arch == arch
        assert isinstance(tr.state.model, ResNetDet)
        assert (save / "cityscapes" / "polydet" / "default" /
                "model_last.pth").exists()
    out = ttest.main(common[:-2] + [
        "--arch", "res_18", "--save_dir", str(tmp_path / "eval"),
        "--load_model", str(tmp_path / "res_18" / "cityscapes" / "polydet" /
                            "default" / "model_last.pth"), "--device", "cpu"])
    assert out["frames"] == 2 and out["ap"] is not None
