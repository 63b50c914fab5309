"""The ctdet task of the PyTorch port against the JAX package's (CPU).

* `CtdetSampler` on test_data.synthetic_coco in train and val, with
  dense_wh, cat_spec_wh, mse_loss (the MSRA gaussian) and elliptical_gt:
  every target equal to JAX's, bit for bit, the rng draw for draw over
  two epochs; the input within the cv2 tolerance of tests/
  test_torch_data.py (the JAX sampler warps with cv2, which rounds to
  uint8; the port's warp is numpy f32);
* `splat_msra_gaussian` equal; the four regression losses, and their
  gradients, within 1e-6;
* `ctdet_loss` in each wh branch (l1, sl1, dense, norm, cat_spec) and
  under mse_loss within 1e-5 relative;
* `ctdet_decode` (with and without reg, cat_spec_wh, 80 classes) and
  `ctdet_post_process` equal;
* one DLA-34 ctdet train step in f64 against `jax_step_f64`, with the
  bounds of tests/test_torch_train.py;
* `CtdetDetector.run`, `run_batch` and flip test against JAX's on the
  same weights, with tests/test_torch_detector.py's bounds;
* `main ctdet` and `test.py` on a COCO box fixture (`--device cpu`);
* the ctdet heads at full width through `state_dict_from_jax` and JAX's
  `import_state_dict`.

Heat maps hold distinct values, so top-K has no ties.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (f64, jax_dla_variables, jax_step_f64,
                               port_batch_f64, port_model, self_sensitivity)
from test_data import synthetic_coco

from centerpoly_tpu.configs import Config as JConfig
from centerpoly_tpu.data import CocoPolyAnnotations as JAnnotations
from centerpoly_tpu.data.ctdet_sampler import CtdetSampler as JSampler
from centerpoly_tpu.data.datasets import CityscapesMeta as JCityscapes
from centerpoly_tpu.geometry import gaussian as jgauss
from centerpoly_tpu.infer import detector as jdet
from centerpoly_tpu.losses import ctdet as jctdet
from centerpoly_tpu.losses import regression as jreg
from centerpoly_tpu.ops import decode as jdec
from centerpoly_tpu.train.torch_import import import_state_dict
from centerpoly_tpu.train.checkpoint import flatten_params
from centerpoly_tpu_torch import main as tmain
from centerpoly_tpu_torch import test as ttest
from centerpoly_tpu_torch import weights
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (CityscapesMeta, CocoMeta,
                                       CocoPolyAnnotations, CtdetSampler,
                                       Loader, SAMPLERS)
from centerpoly_tpu_torch.data.fixture import write_box_fixture
from centerpoly_tpu_torch.geometry import gaussian as tgauss
from centerpoly_tpu_torch.infer.detector import (CtdetDetector,
                                                 create_detector,
                                                 ctdet_post_process)
from centerpoly_tpu_torch.losses import CtdetLossConfig, ctdet_loss
from centerpoly_tpu_torch.losses import regression as treg
from centerpoly_tpu_torch.ops import decode as tdec
from centerpoly_tpu_torch.train import state as tstate
from centerpoly_tpu_torch.train.step import make_train_step

ROUND = 0.5 / 255 / min(Config().std)       # cv2's uint8 rounding, normalised
COCO_IDS = (1, 3, 18, 44, 90)               # a few of COCO's _valid_ids
H, W, HEAD_CONV, LR = 64, 128, 32, 2e-4
HEADS = {"hm": 80, "wh": 2, "reg": 2}


# -- the sampler -------------------------------------------------------------

SAMPLER_CASES = {
    "train": ("train", {}),
    "val": ("val", {}),
    "round": ("train", {"elliptical_gt": False}),
    "dense_wh": ("train", {"dense_wh": True, "elliptical_gt": False}),
    "cat_spec_wh": ("train", {"cat_spec_wh": True}),
    "mse_loss": ("train", {"mse_loss": True, "elliptical_gt": False}),
    "val_cat_spec": ("val", {"cat_spec_wh": True}),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(tmp_path, case):
    split, kw = SAMPLER_CASES[case]
    path = synthetic_coco(str(tmp_path), n_images=3, n_objs=4)
    kw = dict(task="ctdet", input_h=H, input_w=W, **kw)
    port = CtdetSampler(Config(**kw), CityscapesMeta(str(tmp_path)),
                        CocoPolyAnnotations(path), split=split)
    ref = JSampler(JConfig(**kw), JCityscapes(str(tmp_path)),
                   JAnnotations(path), split=split)
    n_pos = 0
    for _ in range(2):                  # the rng runs on across epochs
        for i in range(len(port)):
            got, want = port(i), ref(i)
            assert set(got) == set(want)
            for k in want:
                if k in ("input", "meta"):
                    continue
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            d = np.abs(got["input"] - want["input"])
            assert d.max() < ROUND * 1.4 ** 3 and d.mean() < 0.75 * ROUND
            if split == "val":
                for k in ("c", "s", "img_id", "gt_det"):
                    np.testing.assert_array_equal(got["meta"][k],
                                                  want["meta"][k], err_msg=k)
            n_pos += int(got["reg_mask"].sum())
    assert n_pos > 0
    if kw.get("dense_wh"):
        assert "dense_wh" in got and "wh" not in got
    if kw.get("cat_spec_wh") and not kw.get("dense_wh"):
        assert "cat_spec_wh" in got and "wh" not in got


def test_sampler_registered():
    assert SAMPLERS["ctdet"] is CtdetSampler


# -- gaussian and regression losses ------------------------------------------

def test_msra_gaussian_matches_jax():
    for center in [(5, 7), (0, 0), (31, 19), (-3, 4), (40, 25)]:
        for sigma in (1, 3):
            a = np.zeros((20, 32), np.float32)
            b = np.zeros((20, 32), np.float32)
            a[3, 3] = b[3, 3] = 0.9
            tgauss.splat_msra_gaussian(a, center, sigma)
            jgauss.splat_msra_gaussian(b, center, sigma)
            np.testing.assert_array_equal(a, b)


def _reg_inputs(seed=0, b=2, h=8, w=12, k=6, d=4):
    rng = np.random.RandomState(seed)
    out = rng.randn(b, h, w, d).astype(np.float32)
    ind = rng.randint(0, h * w, (b, k)).astype(np.int32)
    mask = (rng.rand(b, k) < 0.7).astype(np.float32)
    target = (rng.rand(b, k, d) * 3).astype(np.float32)
    # one masked-in target equal to its prediction: |x| at exactly 0
    flat = out.reshape(b, h * w, d)
    mask[0, 0] = 1.0
    target[0, 0] = flat[0, ind[0, 0]]
    return out, mask, ind, target


@pytest.mark.parametrize("name", ["reg_l1_loss", "reg_smooth_l1_loss",
                                  "norm_reg_l1_loss", "reg_weighted_l1_loss",
                                  "dense_l1_loss"])
def test_regression_losses_match_jax(name):
    out, mask, ind, target = _reg_inputs()
    if name == "reg_weighted_l1_loss":
        mask = (np.random.RandomState(1).rand(*target.shape) < 0.6).astype(
            np.float32)
    if name == "dense_l1_loss":
        target = np.random.RandomState(2).randn(*out.shape).astype(np.float32)
        target[0, 0, 0] = out[0, 0, 0]
        mask = (np.random.RandomState(3).rand(*out.shape) < 0.5).astype(
            np.float32)
        args = (mask, target)
    else:
        args = (mask, ind, target)
    jfn, tfn = getattr(jreg, name), getattr(treg, name)
    jv, jg = jax.value_and_grad(lambda o: jfn(o, *map(jnp.asarray, args)))(
        jnp.asarray(out))
    o = torch.tensor(out, requires_grad=True)
    v = tfn(o, *map(torch.from_numpy, args))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


# -- the loss ----------------------------------------------------------------

LOSS_CASES = {
    "l1": {},
    "sl1": {"reg_loss": "sl1"},
    "dense_wh": {"dense_wh": True, "elliptical_gt": False},
    "norm_wh": {"norm_wh": True},
    "cat_spec_wh": {"cat_spec_wh": True},
    "mse_loss": {"mse_loss": True, "elliptical_gt": False},
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_ctdet_loss_matches_jax(tmp_path, case):
    """Two stacks of random head maps on a batch of 2 from the sampler."""
    path = synthetic_coco(str(tmp_path), n_images=2, n_objs=4)
    cfg = Config(task="ctdet", input_h=H, input_w=W, **LOSS_CASES[case])
    sampler = CtdetSampler(cfg, CityscapesMeta(str(tmp_path)),
                           CocoPolyAnnotations(path))
    batch = next(iter(Loader(sampler, 2, 2, shuffle=False)))
    rng = np.random.RandomState(4)
    oh, ow = cfg.output_h, cfg.output_w
    outs = [{k: (rng.randn(2, oh, ow, c) * (2.0 if k == "hm" else 5.0))
             .astype(np.float32) for k, c in cfg.heads.items()}
            for _ in range(2)]
    kw = {k: getattr(cfg, k) for k in (
        "hm_weight", "off_weight", "wh_weight", "mse_loss", "reg_loss",
        "dense_wh", "norm_wh", "cat_spec_wh", "reg_offset")}
    jl, jstats = jctdet.ctdet_loss(
        [{k: jnp.asarray(v) for k, v in o.items()} for o in outs],
        {k: jnp.asarray(v) for k, v in batch.items()},
        jctdet.CtdetLossConfig(**kw))
    tl, tstats = ctdet_loss(
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in outs],
        {k: torch.from_numpy(v) for k, v in batch.items()},
        CtdetLossConfig(**kw))
    assert set(tstats) == set(jstats) == {"loss", "hm_l", "wh_l", "off_l"}
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(tstats["wh_l"]) > 0


# -- decode and post-process -------------------------------------------------

@pytest.mark.parametrize("c,cat_spec,with_reg", [
    (5, False, True), (5, False, False), (5, True, True), (80, True, True),
    (80, False, True)])
def test_ctdet_decode_and_post_process_match_jax(c, cat_spec, with_reg):
    rng = np.random.RandomState(c)
    b, h, w, k = 2, 16, 24, 20
    # distinct scores (rand's f32 values can tie across 80 classes)
    n = b * h * w * c
    heat = ((rng.permutation(n) + 1.0) / (n + 1)).reshape(b, h, w, c).astype(
        np.float32)
    wh = (rng.rand(b, h, w, 2 * c if cat_spec else 2) * 10).astype(np.float32)
    reg = rng.rand(b, h, w, 2).astype(np.float32) if with_reg else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    got = tdec.ctdet_decode(t(heat), t(wh), t(reg), k=k,
                            cat_spec_wh=cat_spec).numpy()
    ref = np.asarray(jdec.ctdet_decode(j(heat), j(wh), j(reg), k=k,
                                       cat_spec_wh=cat_spec))
    assert got.shape == (b, k, 6)
    np.testing.assert_array_equal(got, ref)
    cs = [np.array([300.0, 200.0], np.float32), np.array([90.0, 60.0],
                                                          np.float32)]
    ss = [640.0, 200.0]
    pp = ctdet_post_process(got, cs, ss, h, w, c)
    jpp = jdet.ctdet_post_process(ref, cs, ss, h, w, c)
    for a, r in zip(pp, jpp):
        assert set(a) == set(r) == set(range(1, c + 1))
        for cls in r:
            np.testing.assert_array_equal(np.asarray(a[cls]).reshape(-1, 5),
                                          np.asarray(r[cls]).reshape(-1, 5))


# -- one train step ----------------------------------------------------------

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """A COCO box fixture of PNG frames (both packages read the same
    pixels: cv2 in JAX's sampler, utils/png.py in the port's)."""
    return write_box_fixture(str(tmp_path_factory.mktemp("coco")),
                             {"train": 4, "val": 2}, 0, 2 * H, 2 * W,
                             categories=COCO_IDS, png=True)


def test_train_step_matches_jax(monkeypatch, coco_root):
    """One DLA-34 ctdet step (80 classes, 64x128, batch 2) of each package
    in f64 from the same random weights: each loss part within 4x the
    port's own floor (+1e-5 relative), the parameters after Adam within
    2 lr + 1e-6, each gradient within 4x its floor + 1e-3 in relative L2,
    the BatchNorm statistics within rtol 1e-4, atol 4x floor + 1e-5."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    cfg = Config(task="ctdet", dataset="coco", input_h=H, input_w=W,
                 head_conv=HEAD_CONV)
    meta = CocoMeta(coco_root)
    sampler = CtdetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    host = next(iter(Loader(sampler, len(sampler), 2, shuffle=False)))
    assert host["reg_mask"].sum() >= 2
    variables = f64(jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=3)[1])
    jstats, jgrads, jafter = jax_step_f64("dla_34", HEADS, HEAD_CONV, (H, W),
                                          LR, {}, variables, host,
                                          task="ctdet")
    net = port_model(variables, HEADS, HEAD_CONV).double()
    batch = port_batch_f64(host)
    stat_floor, grad_floor, buf_floor = self_sensitivity(
        net, batch, CtdetLossConfig(), ctdet_loss)
    st = tstate.create_train_state(net, base_lr=LR)
    st, stats = make_train_step(CtdetLossConfig(), ctdet_loss)(st, batch)
    assert set(stats) == set(jstats)
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
    assert sum("conv_offset_mask" in n for n in grad_floor) == 32
    for name, floor in buf_floor.items():
        np.testing.assert_allclose(
            net.get_buffer(name).numpy(), jafter[name].numpy(), rtol=1e-4,
            atol=4 * floor + 1e-5, err_msg=name)


# -- the detector ------------------------------------------------------------

KW = dict(task="ctdet", dataset="coco", input_h=H, input_w=W,
          head_conv=HEAD_CONV, K=16, mixed_precision=False)


@pytest.fixture(scope="module")
def variables():
    return jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=8)[1]


@pytest.fixture
def jax_env(monkeypatch):
    """As tests/test_torch_detector.py: the JAX Config's DCN env var
    starts unset and is handed back unset; no host pre-shrink."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    monkeypatch.setattr(jdet.BaseDetector, "_shrink_for_send",
                        lambda self, image, trans, h, w: (image, trans))
    yield
    JConfig(**KW)


def _frame(seed=11):
    return np.random.RandomState(seed).randint(0, 256, (2 * H, 2 * W, 3),
                                               dtype=np.uint8)


def _same_boxes(got, ref) -> int:
    """Per class the same rows: score within 1e-3, box within 1e-2 px."""
    n = 0
    for j in range(1, 81):
        g, r = np.asarray(got[j]), np.asarray(ref[j])
        assert g.shape == r.shape, j
        n += len(r)
        np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, :4], r[:, :4], rtol=0, atol=1e-2)
    return n


@pytest.mark.parametrize("extra", [
    {"dcn_kernel": "rowband:6"}, {"dcn_kernel": "off"},
    {"dcn_kernel": "rowband:6", "flip_test": True}],
    ids=["rowband6", "off", "flip_test"])
def test_detector_matches_jax(jax_env, variables, extra):
    frame = _frame()
    ref = jdet.create_detector(JConfig(**KW, **extra), variables).run(frame)
    port = create_detector(Config(**KW, **extra), variables, device="cpu")
    assert isinstance(port, CtdetDetector)
    got = port.run(frame)
    assert set(got) == set(ref)
    assert _same_boxes(got["results"], ref["results"]) == 16
    batch = port.run_batch([frame, _frame(12)])
    for j in range(1, 81):
        np.testing.assert_allclose(batch[0]["results"][j],
                                   got["results"][j], rtol=0, atol=1e-2)
    jbatch = jdet.create_detector(JConfig(**KW, **extra), variables
                                  ).run_batch([frame, _frame(12)])
    assert _same_boxes(batch[1]["results"], jbatch[1]["results"]) == 16


def test_detector_run_stream_matches_run(variables):
    det = create_detector(Config(**KW), variables, device="cpu")
    frames = [_frame(s) for s in (11, 12, 13)]
    refs = [det.run(f)["results"] for f in frames]
    for got, ref in zip(det.run_stream(iter(frames), depth=2), refs):
        for j in ref:
            np.testing.assert_array_equal(got[j], ref[j])


# -- the CLIs ----------------------------------------------------------------

def test_main_and_test_on_a_coco_fixture(tmp_path, coco_root):
    """`main ctdet` for one epoch of 2 steps with validation, then
    test.py on its model_best in the same arithmetic (f32, exact DCN):
    the COCO AP file has every key, and test.py's AP is main's."""
    common = ["ctdet", "--dataset", "coco", "--data_dir", coco_root,
              "--save_dir", str(tmp_path / "exp"), "--input_h", "64",
              "--input_w", "64", "--head_conv", "16", "--K", "20",
              "--device", "cpu"]
    tr = tmain.main(common + ["--batch_size", "2", "--num_workers", "0",
                              "--num_epochs", "1", "--val_intervals", "1"])
    assert tr.state.step == 2
    save_dir = tmp_path / "exp" / "coco" / "ctdet" / "default"
    main_ap = json.loads((save_dir / "coco_eval.json").read_text())
    assert set(main_ap) == {"AP", "AP50", "AP75", "AR100", "APs", "APm",
                            "APl"}
    scalars = [json.loads(line) for d, _, fs in os.walk(save_dir)
               for f in fs if f == "scalars.jsonl"
               for line in open(os.path.join(d, f))]
    losses = [s["value"] for s in scalars if s["tag"] == "train_loss"]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert [s["value"] for s in scalars if s["tag"] == "val_AP"] == [
        main_ap["AP"]]
    assert (save_dir / "model_best.pth").exists()
    out = ttest.main(common + ["--load_model", str(save_dir / "model_best.pth"),
                               "--dcn_kernel", "off"])
    assert out["frames"] == 2 and out["ap"] == main_ap
    rows = np.concatenate([np.asarray(v) for r in out["results"].values()
                           for v in r.values()])
    assert rows.shape == (40, 5) and np.isfinite(rows).all()


# -- weights -----------------------------------------------------------------

@pytest.mark.parametrize("cat_spec", [False, True])
def test_ctdet_heads_round_trip_at_full_width(cat_spec):
    """The ctdet heads at full width (head_conv 256; hm 80, wh 2 or 160,
    reg 2) map to the port's names and back through JAX's
    import_state_dict, every array exactly."""
    heads = dict(Config(task="ctdet", dataset="coco",
                        cat_spec_wh=cat_spec).heads)
    assert heads == {"hm": 80, "wh": 160 if cat_spec else 2, "reg": 2}
    _, variables = jax_dla_variables(heads, 256, 64, 64, seed=5)
    sd = weights.state_dict_from_jax(variables)
    own = port_model(variables, heads, 256).state_dict()
    for name, c in heads.items():
        assert tuple(sd[f"{name}.0.weight"].shape) == (256, 64, 3, 3)
        assert tuple(sd[f"{name}.2.weight"].shape) == (c, 256, 1, 1)
        torch.testing.assert_close(own[f"{name}.2.bias"], sd[f"{name}.2.bias"])
    zeros = jax.tree.map(np.zeros_like, variables)
    back, report = import_state_dict({k: v.numpy() for k, v in sd.items()},
                                     zeros, "dla_34")
    assert report["skipped"] == []
    want = flatten_params(variables["params"])
    got = flatten_params(back["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ctdet_config_fields_parse():
    cfg = Config.from_args(["ctdet", "--dataset", "coco", "--reg_loss", "sl1",
                            "--wh_weight", "0.2", "--dense_wh", "--norm_wh",
                            "--hm_gauss", "5", "--cat_spec_wh"])
    assert (cfg.reg_loss, cfg.wh_weight, cfg.dense_wh, cfg.norm_wh,
            cfg.hm_gauss, cfg.heads["wh"]) == ("sl1", 0.2, True, True, 5, 160)
    ref = JConfig(task="ctdet", dataset="coco")
    port = Config(task="ctdet", dataset="coco")
    for k in ("reg_loss", "wh_weight", "dense_wh", "norm_wh", "hm_gauss",
              "cat_spec_wh", "num_classes", "input_h", "input_w", "mean",
              "std"):
        assert getattr(port, k) == getattr(ref, k), k
    assert dict(port.heads) == dict(ref.heads)
    with pytest.raises(ValueError, match="kitti2d"):
        Config(task="ctdet", dataset="kitti2d")
    with pytest.raises(ValueError, match="kitti2d"):
        JConfig(task="ctdet", dataset="kitti2d")
