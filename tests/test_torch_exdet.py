"""The exdet (ExtremeNet) task of the PyTorch port against the JAX
package's (CPU).

* `ExdetSampler` on a COCO box fixture (PNG frames, extreme points on
  most boxes, the edge midpoints for the rest) in train and val, with
  agnostic_ex and under mse_loss: every target equal to JAX's, bit for
  bit, the rng draw for draw over two epochs; the input within
  tests/test_torch_ctdet.py's cv2 bound (`ROUND`: the JAX sampler warps
  with cv2, which rounds to uint8; the port's warp is numpy f32);
* `exdet_loss` on two stacks, with and without reg_offset and under
  mse_loss, within rtol 1e-5;
* `_agg_scan` on both axes in both directions within rtol 1e-6;
* `exct_decode` at 32x32 maps of 2-3 classes, K 8, with and without the
  offsets, aggr_weight 0 and 0.5: its rows with score > 0 as sorted sets
  within 1e-5 (the rest are penalised lattice cells, many of them tied,
  which torch.topk and lax.top_k order differently);
* `ExdetDetector.run` and `run_batch` against JAX's on the same weights,
  after `merge_outputs` (score within 1e-3, box within 1e-2 px), with and
  without flip_test, where the port runs a batch of 1 (flip_tta off);
* one DLA-34 exdet train step in f64 against `jax_step_f64`, with the
  bounds of tests/test_torch_train.py;
* `main exdet` and `test.py` on the fixture (`--device cpu`);
* the exdet heads at full width through `state_dict_from_jax` and JAX's
  `import_state_dict`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (f64, jax_dla_variables, jax_step_f64,
                               port_batch_f64, port_model, self_sensitivity)

from centerpoly_tpu.configs import Config as JConfig
from centerpoly_tpu.data import CocoPolyAnnotations as JAnnotations
from centerpoly_tpu.data.datasets import CocoMeta as JCocoMeta
from centerpoly_tpu.data.exdet_sampler import ExdetSampler as JSampler
from centerpoly_tpu.infer import detector as jdet
from centerpoly_tpu.losses import exdet as jexdet
from centerpoly_tpu.ops import decode as jdec
from centerpoly_tpu.train.checkpoint import flatten_params
from centerpoly_tpu.train.torch_import import import_state_dict
from centerpoly_tpu_torch import main as tmain
from centerpoly_tpu_torch import test as ttest
from centerpoly_tpu_torch import weights
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (SAMPLERS, CocoMeta,
                                       CocoPolyAnnotations, ExdetSampler,
                                       Loader)
from centerpoly_tpu_torch.data.fixture import write_box_fixture
from centerpoly_tpu_torch.infer.detector import DETECTORS, create_detector
from centerpoly_tpu_torch.infer.task_detectors import ExdetDetector
from centerpoly_tpu_torch.losses import ExdetLossConfig, exdet_loss
from centerpoly_tpu_torch.ops import decode as tdec
from centerpoly_tpu_torch.train import state as tstate
from centerpoly_tpu_torch.train.step import make_train_step

ROUND = 0.5 / 255 / min(Config().std)       # cv2's uint8 rounding, normalised
COCO_IDS = (1, 3, 18, 44, 90)               # a few of COCO's _valid_ids
H, W, HEAD_CONV, LR = 64, 128, 32, 2e-4
HEADS = Config(task="exdet", dataset="coco").heads


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """A COCO box fixture of PNG frames (both packages read the same
    pixels: cv2 in JAX's sampler, utils/png.py in the port's)."""
    return write_box_fixture(str(tmp_path_factory.mktemp("coco")),
                             {"train": 4, "val": 2}, 0, 2 * H, 2 * W,
                             categories=COCO_IDS, png=True)


# -- the sampler -------------------------------------------------------------

SAMPLER_CASES = {
    "train": ("train", {}),
    "val": ("val", {}),
    "agnostic_ex": ("train", {"agnostic_ex": True}),
    "mse_loss": ("train", {"mse_loss": True}),
    "no_reg_offset": ("val", {"reg_offset": False}),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(coco_root, case):
    split, kw = SAMPLER_CASES[case]
    kw = dict(task="exdet", dataset="coco", input_h=H, input_w=W, **kw)
    meta, jmeta = CocoMeta(coco_root), JCocoMeta(coco_root)
    path = meta.annot_path(split)
    port = ExdetSampler(Config(**kw), meta, CocoPolyAnnotations(path),
                        split=split, img_dir=meta.img_dir(split))
    ref = JSampler(JConfig(**kw), jmeta, JAnnotations(path), split=split,
                   img_dir=jmeta.img_dir(split))
    anns = CocoPolyAnnotations(path).dataset["annotations"]
    assert any("extreme_points" in a for a in anns)
    assert any("extreme_points" not in a for a in anns)
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
                for k in ("c", "s", "img_id"):
                    np.testing.assert_array_equal(got["meta"][k],
                                                  want["meta"][k], err_msg=k)
            n_pos += int((got["hm_c"] == 1).sum())
    assert n_pos > 0
    assert got["hm_t"].shape[-1] == (1 if kw.get("agnostic_ex") else 80)
    assert ("reg_mask" in got) == kw.get("reg_offset", True)


def test_sampler_registered():
    assert SAMPLERS["exdet"] is ExdetSampler


# -- the loss ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"reg_offset": False}, {"mse_loss": True},
                                {"off_weight": 0.5, "hm_weight": 2.0}],
                         ids=["default", "no_reg_offset", "mse_loss",
                              "weights"])
def test_exdet_loss_matches_jax(coco_root, kw):
    """Two stacks of random head maps on a train batch of 2."""
    cfg = Config(task="exdet", dataset="coco", input_h=H, input_w=W,
                 mse_loss=kw.get("mse_loss", False))
    meta = CocoMeta(coco_root)
    sampler = ExdetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    batch = next(iter(Loader(sampler, 2, 2, shuffle=False)))
    assert batch["reg_mask"].sum() > 0
    rng = np.random.RandomState(4)
    oh, ow = cfg.output_h, cfg.output_w
    outs = [{k: (rng.randn(2, oh, ow, c) * (2.0 if k.startswith("hm")
                                             else 0.5)).astype(np.float32)
             for k, c in cfg.heads.items()} for _ in range(2)]
    jl, jstats = jexdet.exdet_loss(
        [{k: jnp.asarray(v) for k, v in o.items()} for o in outs],
        {k: jnp.asarray(v) for k, v in batch.items()},
        jexdet.ExdetLossConfig(**kw))
    tl, tstats = exdet_loss(
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in outs],
        {k: torch.from_numpy(v) for k, v in batch.items()},
        ExdetLossConfig(**kw))
    assert set(tstats) == set(jstats) == {"loss", "hm_l", "off_l"}
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert (float(tstats["off_l"]) > 0) == kw.get("reg_offset", True)


# -- the decode --------------------------------------------------------------

@pytest.mark.parametrize("axis,reverse", [(1, False), (1, True), (2, False),
                                          (2, True)])
def test_agg_scan_matches_jax(axis, reverse):
    heat = np.random.RandomState(axis + 2 * reverse).rand(2, 12, 16, 3)
    heat = heat.astype(np.float32)
    got = tdec._agg_scan(torch.from_numpy(heat), axis, reverse).numpy()
    ref = np.asarray(jdec._agg_scan(jnp.asarray(heat), axis, reverse))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.abs(ref).max() > 0


def _exdet_maps(seed, b, h, w, c, n_obj=3, peak=(0.3, 0.8)):
    """Five (B, H, W, C) maps and four (B, H, W, 2) offset maps: a
    background of distinct values in (0, 0.05) (no top-K ties among
    peaks) with `n_obj` boxes a frame planted on it, each its class's
    four extreme points and centre at values drawn from `peak`."""
    rng = np.random.RandomState(seed)
    n = b * h * w * c
    heats = [(0.05 * (rng.permutation(n) + 1.0) / (n + 1)).reshape(
        b, h, w, c).astype(np.float32) for _ in range(5)]
    for i in range(b):
        for _ in range(n_obj):
            cls = rng.randint(c)
            x0, y0 = rng.randint(0, w // 2, 2)
            x1, y1 = x0 + rng.randint(4, w // 2), y0 + rng.randint(4, h // 2)
            pts = [(rng.randint(x0, x1 + 1), y0), (x0, rng.randint(y0, y1 + 1)),
                   (rng.randint(x0, x1 + 1), y1), (x1, rng.randint(y0, y1 + 1)),
                   (int((x0 + x1 + 0.5) / 2), int((y0 + y1 + 0.5) / 2))]
            for heat, (x, y) in zip(heats, pts):
                heat[i, y, x, cls] = rng.uniform(*peak)
    regs = [rng.rand(b, h, w, 2).astype(np.float32) for _ in range(4)]
    return heats, regs


def _positive_rows(dets):
    """Per image the rows with score > 0, sorted (lexicographically)."""
    out = []
    for d in np.asarray(dets, np.float64):
        d = d[d[:, 4] > 0]
        out.append(d[np.lexsort(d.T[::-1])])
    return out


@pytest.mark.parametrize("c,with_reg,aggr", [
    (2, True, 0.0), (3, False, 0.0), (3, True, 0.5), (2, False, 0.5)])
def test_exct_decode_matches_jax(c, with_reg, aggr):
    # with aggregation, peaks low enough that the aggregated edge maps stay
    # below 1, where exct_decode clamps (a clamped map's peaks tie)
    heats, regs = _exdet_maps(c + 10 * with_reg, 2, 32, 32, c,
                              peak=(0.2, 0.4) if aggr else (0.3, 0.8))
    if aggr:
        for h, axis in zip(heats[:4], (2, 1, 2, 1)):
            t_h = torch.from_numpy(h)
            agg = t_h + aggr * (tdec._agg_scan(t_h, axis, False)
                                + tdec._agg_scan(t_h, axis, True))
            assert agg.max() < 1
    if not with_reg:
        regs = [None] * 4
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    kw = dict(k=8, aggr_weight=aggr, num_dets=64)
    got = tdec.exct_decode(*map(t, heats), *map(t, regs), **kw).numpy()
    ref = np.asarray(jdec.exct_decode(*map(j, heats), *map(j, regs), **kw))
    assert got.shape == ref.shape == (2, 64, 14)
    n = 0
    for g, r in zip(_positive_rows(got), _positive_rows(ref)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
        n += len(r)
    assert n > 0
    # the best rows come in the same order
    np.testing.assert_allclose(got[:, :n // 4], ref[:, :n // 4], atol=1e-5)


# -- the detector ------------------------------------------------------------

KW = dict(task="exdet", dataset="coco", input_h=H, input_w=W,
          head_conv=HEAD_CONV, K=16, mixed_precision=False)


@pytest.fixture(scope="module")
def variables():
    """Random weights for the 80-class heads and the agnostic ones (on
    random weights every edge map lies near 0.5, and the 80-class lattice
    finds no four peaks of one class in order, so only the agnostic heads
    give rows)."""
    return {ag: jax_dla_variables(Config(**KW, agnostic_ex=ag).heads,
                                  HEAD_CONV, H, W, seed=8)[1]
            for ag in (False, True)}


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


@pytest.mark.parametrize("extra,rows", [
    ({"dcn_kernel": "rowband:6", "agnostic_ex": True}, 16),
    ({"dcn_kernel": "off", "agnostic_ex": True, "flip_test": True}, 16),
    ({"dcn_kernel": "rowband:6"}, 0)],
    ids=["rowband6", "off_flip_test", "80_classes"])
def test_detector_matches_jax(jax_env, variables, extra, rows):
    frame = _frame()
    sd = variables[extra.get("agnostic_ex", False)]
    ref = jdet.create_detector(JConfig(**KW, **extra), sd).run(frame)
    port = create_detector(Config(**KW, **extra), sd, device="cpu")
    assert isinstance(port, ExdetDetector) and not port.flip_tta
    batches = []
    hook = port.model.register_forward_pre_hook(
        lambda mod, args: batches.append(args[0].shape[0]))
    got = port.run(frame)
    assert batches == [1]               # no flipped half, also under flip_test
    hook.remove()
    assert set(got) == set(ref)
    assert _same_boxes(got["results"], ref["results"]) == rows
    for r in got["results"].values():
        assert r.shape[1] == 5 and (r[:, 4] > 0).all()
    batch = port.run_batch([frame, _frame(13)])
    for j in range(1, 81):
        np.testing.assert_allclose(batch[0]["results"][j],
                                   got["results"][j], rtol=0, atol=1e-2)
    jbatch = jdet.create_detector(JConfig(**KW, **extra), sd
                                  ).run_batch([frame, _frame(13)])
    assert _same_boxes(batch[1]["results"], jbatch[1]["results"]) == rows


def test_detector_flip_test_is_a_no_op(variables):
    """flip_tta off: flip_test gives the results of a plain run, also
    through run_stream."""
    frame = _frame(13)
    kw = dict(KW, agnostic_ex=True)
    plain = create_detector(Config(**kw), variables[True], device="cpu")
    flip = create_detector(Config(**kw, flip_test=True), variables[True],
                           device="cpu")
    a, b = plain.run(frame)["results"], flip.run(frame)["results"]
    assert sum(len(r) for r in a.values()) > 0
    for j in a:
        np.testing.assert_array_equal(a[j], b[j])
    for got, ref in zip(flip.run_stream(iter([frame]), depth=2), [a]):
        for j in ref:
            np.testing.assert_array_equal(got[j], ref[j])


def test_detector_registered():
    """exdet is registered; a task with no detector is refused (every
    task of the JAX package has one now, so the config names another)."""
    assert DETECTORS["exdet"] is ExdetDetector
    cfg = Config(task="exdet", dataset="coco")
    cfg.task = "no_such_task"
    with pytest.raises(ValueError, match="unknown task 'no_such_task'"):
        create_detector(cfg, device="cpu")


# -- one train step ----------------------------------------------------------

def test_train_step_matches_jax(monkeypatch, coco_root):
    """One DLA-34 exdet step (80 classes, 64x128, batch 2) of each package
    in f64 from the same random weights: each loss part within 4x the
    port's own floor (+1e-5 relative), the parameters after Adam within
    2 lr + 1e-6, each gradient within 4x its floor + 1e-3 in relative L2,
    the BatchNorm statistics within rtol 1e-4, atol 4x floor + 1e-5."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    cfg = Config(task="exdet", dataset="coco", input_h=H, input_w=W,
                 head_conv=HEAD_CONV)
    meta = CocoMeta(coco_root)
    sampler = ExdetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    host = next(iter(Loader(sampler, len(sampler), 2, shuffle=False)))
    assert host["reg_mask"].sum() >= 2
    variables = f64(jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=3)[1])
    jstats, jgrads, jafter = jax_step_f64("dla_34", HEADS, HEAD_CONV, (H, W),
                                          LR, {}, variables, host,
                                          task="exdet")
    net = port_model(variables, HEADS, HEAD_CONV).double()
    batch = port_batch_f64(host)
    stat_floor, grad_floor, buf_floor = self_sensitivity(
        net, batch, ExdetLossConfig(), exdet_loss)
    st = tstate.create_train_state(net, base_lr=LR)
    st, stats = make_train_step(ExdetLossConfig(), exdet_loss)(st, batch)
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


# -- the CLIs ----------------------------------------------------------------

def test_main_and_test_on_a_coco_fixture(tmp_path, coco_root):
    """`main exdet` for one epoch of 2 steps with validation (on the val
    loss: exdet's val batches are not decoded, as in JAX), then test.py
    on its model_best: coco_eval.json with every key."""
    common = ["exdet", "--dataset", "coco", "--data_dir", coco_root,
              "--save_dir", str(tmp_path / "exp"), "--input_h", "64",
              "--input_w", "64", "--head_conv", "16", "--K", "20",
              "--device", "cpu"]
    tr = tmain.main(common + ["--batch_size", "2", "--num_workers", "0",
                              "--num_epochs", "1", "--val_intervals", "1"])
    assert tr.state.step == 2
    save_dir = tmp_path / "exp" / "coco" / "exdet" / "default"
    assert (save_dir / "model_best.pth").exists()
    assert np.isfinite(tr.best) and tr.best < 0      # -val_loss
    assert not (save_dir / "coco_eval.json").exists()
    out = ttest.main(common + ["--load_model", str(save_dir / "model_best.pth"),
                               "--dcn_kernel", "off"])
    assert out["frames"] == 2
    assert set(out["ap"]) == {"AP", "AP50", "AP75", "AR100", "APs", "APm",
                              "APl"}
    assert (save_dir / "coco_eval.json").exists()
    for per_class in out["results"].values():
        for rows in per_class.values():
            assert rows.shape[1] == 5 and np.isfinite(rows).all()


# -- weights -----------------------------------------------------------------

@pytest.mark.parametrize("agnostic", [False, True])
def test_exdet_heads_round_trip_at_full_width(agnostic):
    """The exdet heads at full width (head_conv 256; hm_{t,l,b,r} 80 or 1,
    hm_c 80, reg_{t,l,b,r} 2) map to the port's names and back
    through JAX's import_state_dict, every array exactly."""
    heads = dict(Config(task="exdet", dataset="coco",
                        agnostic_ex=agnostic).heads)
    hc = 1 if agnostic else 80
    assert heads == {"hm_t": hc, "hm_l": hc, "hm_b": hc, "hm_r": hc,
                     "hm_c": 80, "reg_t": 2, "reg_l": 2, "reg_b": 2,
                     "reg_r": 2}
    assert heads == dict(JConfig(task="exdet", dataset="coco",
                                 agnostic_ex=agnostic).heads)
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
