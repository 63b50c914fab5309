"""The ddd task (monocular 3D boxes on KITTI) of the PyTorch port against
the JAX package's (CPU).

* `DddSampler` on a KITTI 3D fixture (`write_kitti3d_fixture`: 1242x375
  PNG frames, Van / Person_sitting / Truck / DontCare ignore regions and
  Misc skipped) in train with aug_ddd 0 and 1 and in val: every target
  equal to JAX's, bit for bit, the rng draw for draw over two epochs; the
  input within tests/test_torch_ctdet.py's cv2 bound (`ROUND`); the val
  meta's c, s, img_id and gt_det equal;
* `bin_rot_loss` and `ddd_loss` (default, mse_loss, reg_bbox off,
  reg_offset off, the loss weights at 0) on two stacks in f64, value and
  gradient within rtol 1e-9 (atol 1e-12);
* the loss over two gloo ranks (one of them with no selected row): the
  ranks' shares sum to the one-process loss of the global batch and
  their head-map gradients are its gradients, within 1e-12 (f64);
* `ddd_decode` with and without wh and reg within 1e-5 (distinct heat
  values: no ties); `geometry/ddd.py` and both post-processes equal;
* `DddDetector` against JAX's on carried res_18 weights (96x320 frames,
  64x192 input): `run`, `run_batch`, `run_stream`, `--flip_test` (a
  batch of 1, the plain results), reg_bbox off, and the test scale 0.5,
  at which JAX's rows move and the port's equal its scale-1 rows; rows
  held as sets, score within 1e-4, every other column within 1e-3
  relative (+1e-3); the --debug view cuts a row on its score (the last
  column) and draws its box (columns 1-4);
* one DLA-34 ddd train step in f64 against `jax_step_f64`, with the
  bounds of tests/test_torch_train.py;
* `main ddd` and `test.py` on the fixture: the KITTI files the port's
  writer and JAX's write from test.py's results are byte-equal, and the
  native evaluator's numbers (the port's build and JAX's) are equal;
  the fixture's GT as results scores AP 100;
* `main ddd` and `test.py` in a subprocess with cv2, PIL and JAX
  unimportable.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (f64, jax_dla_variables, jax_step_f64,
                               jax_variables, port_batch_f64, port_model,
                               self_sensitivity)

from centerpoly_tpu.configs import Config as JConfig
from centerpoly_tpu.data import CocoPolyAnnotations as JAnnotations
from centerpoly_tpu.data.datasets import DATASETS as JDATASETS
from centerpoly_tpu.data.ddd_sampler import DddSampler as JSampler
from centerpoly_tpu.data.ddd_sampler import alpha_to_8 as jalpha_to_8
from centerpoly_tpu.eval import native as jnative
from centerpoly_tpu.geometry import ddd as jgeo
from centerpoly_tpu.infer import detector as jdet
from centerpoly_tpu.infer import task_detectors as jtask
from centerpoly_tpu.losses import ddd as jddd
from centerpoly_tpu.losses import regression as jreg
from centerpoly_tpu.ops import decode as jdec
from centerpoly_tpu.train.checkpoint import flatten_params
from centerpoly_tpu.train.torch_import import import_state_dict
from centerpoly_tpu_torch import main as tmain
from centerpoly_tpu_torch import test as ttest
from centerpoly_tpu_torch import weights
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (DATASETS, SAMPLERS,
                                       CocoPolyAnnotations, DddSampler,
                                       KittiMeta, Loader)
from centerpoly_tpu_torch.data.ddd_sampler import alpha_to_8
from centerpoly_tpu_torch.data.fixture import (KITTI_CATEGORIES,
                                               write_kitti3d_fixture)
from centerpoly_tpu_torch.eval import native
from centerpoly_tpu_torch.geometry import ddd as tgeo
from centerpoly_tpu_torch.infer.detector import DETECTORS, create_detector
from centerpoly_tpu_torch.infer.task_detectors import (
    DEFAULT_CALIB, DddDetector, ddd_post_process_2d, ddd_post_process_3d)
from centerpoly_tpu_torch.losses import DddLossConfig, ddd_loss
from centerpoly_tpu_torch.losses import regression as treg
from centerpoly_tpu_torch.ops import decode as tdec
from centerpoly_tpu_torch.train import state as tstate
from centerpoly_tpu_torch.train.step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND = 0.5 / 255 / min(Config().std)       # cv2's uint8 rounding, normalised
H, W, HEAD_CONV, LR = 64, 192, 32, 2e-4
KITTI = dict(task="ddd", dataset="kitti")
HEADS = Config(**KITTI).heads
SPLITS = {"train": 4, "val": 2}


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """A KITTI 3D fixture of PNG frames (both packages read the same
    pixels: cv2 in JAX's sampler, utils/png.py in the port's)."""
    return write_kitti3d_fixture(str(tmp_path_factory.mktemp("kitti")),
                                 SPLITS, 0)


def _samplers(root, split, **kw):
    kw = dict(KITTI, input_h=H, input_w=W, **kw)
    meta, jmeta = KittiMeta(root), JDATASETS["kitti"](root)
    path = meta.annot_path(split)
    return (DddSampler(Config(**kw), meta, CocoPolyAnnotations(path),
                       split=split, img_dir=meta.img_dir(split)),
            JSampler(JConfig(**kw), jmeta, JAnnotations(path), split=split,
                     img_dir=jmeta.img_dir(split)))


# -- the sampler -------------------------------------------------------------

SAMPLER_CASES = {
    "train_aug0": ("train", {"aug_ddd": 0.0}),
    "train_aug1": ("train", {"aug_ddd": 1.0}),
    "val": ("val", {}),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(kitti_root, case):
    split, kw = SAMPLER_CASES[case]
    port, ref = _samplers(kitti_root, split, **kw)
    n_rot = n_reg = 0
    ignored = False
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
                assert got["meta"]["gt_det"].shape[1] in (16, 18)
            # each annotation keeps its slot; Misc (-99) and the ignore
            # regions leave theirs empty
            for k, ann in enumerate(port.coco.load_anns(port.images[i])):
                if port.meta.cat_ids[ann["category_id"]] < 0:
                    assert got["rot_mask"][k] == 0 and got["ind"][k] == 0
            ignored |= bool((got["hm"] == np.float32(0.9999)).any())
            n_rot += int(got["rot_mask"].sum())
            n_reg += int(got["reg_mask"].sum())
    assert n_rot > 0 and ignored
    # under aug_ddd the depth is not the frame's: reg_mask 0, rot_mask 1
    assert (n_reg == 0) == (kw.get("aug_ddd") == 1.0)
    if kw.get("aug_ddd") != 1.0:
        assert n_reg == n_rot


def test_sampler_val_without_objects(tmp_path):
    """A val frame whose every annotation is skipped or ignored gets the
    (1, 18) zeros of gt_det in both packages."""
    import json
    root = write_kitti3d_fixture(str(tmp_path), {"val": 2}, 3)
    meta = KittiMeta(root)
    path = meta.annot_path("val")
    data = json.load(open(path))
    for a in data["annotations"]:
        a["category_id"] = 7                # Misc: skipped
    json.dump(data, open(path, "w"))
    port, ref = _samplers(root, "val")
    got, want = port(0), ref(0)
    assert got["meta"]["gt_det"].shape == (1, 18)
    np.testing.assert_array_equal(got["meta"]["gt_det"],
                                  want["meta"]["gt_det"])
    assert got["hm"].max() == 0 == want["hm"].max()


def test_alpha_to_8_and_registration():
    for a in np.linspace(-np.pi, np.pi, 37):
        np.testing.assert_array_equal(alpha_to_8(a), jalpha_to_8(a))
    assert SAMPLERS["ddd"] is DddSampler
    assert DETECTORS["ddd"] is DddDetector
    assert DATASETS["kitti"] is KittiMeta
    assert set(KITTI_CATEGORIES) == set(KittiMeta("").cat_ids)


# -- the losses --------------------------------------------------------------

def _bin_rot_inputs(seed, b=2, h=8, w=12, k=6, all_zero_bins=False):
    rng = np.random.RandomState(seed)
    out = rng.randn(b, h, w, 8) * 2
    ind = rng.randint(0, h * w, (b, k)).astype(np.int32)
    mask = (rng.rand(b, k) < 0.7).astype(np.float64)
    rotbin = rng.randint(0, 2, (b, k, 2)).astype(np.int32)
    if all_zero_bins:
        rotbin[:] = 0
    rotres = rng.uniform(-np.pi, np.pi, (b, k, 2))
    return out, mask, ind, rotbin, rotres


@pytest.mark.parametrize("zero_bins", [False, True], ids=["bins", "no_bins"])
def test_bin_rot_loss_and_gradient_match_jax(zero_bins):
    """f64 value and gradient; with no nonzero bin label the residual
    terms are 0 (the n > 0 test) and only the two cross-entropies stay."""
    out, mask, ind, rotbin, rotres = _bin_rot_inputs(1, all_zero_bins=zero_bins)
    t = torch.tensor(out, requires_grad=True)
    got = treg.bin_rot_loss(t, torch.tensor(mask), torch.tensor(ind),
                            torch.tensor(rotbin), torch.tensor(rotres))
    got.backward()
    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in (mask, ind, rotbin, rotres)]
        ref, grad = jax.value_and_grad(
            lambda o: jreg.bin_rot_loss(o, *args))(jnp.asarray(out))
        ref, grad = float(ref), np.asarray(grad)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(t.grad.numpy(), grad, rtol=1e-9, atol=1e-12)
    if zero_bins:
        # two cross-entropies over every row, masked rows at log 2 each
        assert got.item() > 0


LOSS_CASES = {
    "default": {},
    "mse_loss": {"mse_loss": True},
    "no_reg_bbox": {"reg_bbox": False},
    "no_reg_offset": {"reg_offset": False},
    "zero_weights": {"dep_weight": 0.0, "dim_weight": 0.0,
                     "rot_weight": 0.0},
}


def _loss_batch(root, seed=4, **kw):
    """A train batch of 2 (aug_ddd 0: depth rows present) and two stacks
    of random f64 head maps at its output size."""
    cfg = Config(**KITTI, input_h=H, input_w=W, aug_ddd=0.0, **kw)
    meta = KittiMeta(root)
    sampler = DddSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    batch = {k: v for k, v in next(iter(Loader(sampler, 2, 2,
                                                shuffle=False))).items()
             if k != "input"}
    rng = np.random.RandomState(seed)
    outs = [{k: rng.randn(2, cfg.output_h, cfg.output_w, c) * 2
             for k, c in cfg.heads.items()} for _ in range(2)]
    return cfg, f64(batch), outs


def _loss_kw(cfg):
    return {k: getattr(cfg, k) for k in (
        "hm_weight", "dep_weight", "dim_weight", "rot_weight", "wh_weight",
        "off_weight", "mse_loss", "reg_bbox", "reg_offset")}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_ddd_loss_and_gradient_match_jax(kitti_root, case):
    cfg, batch, outs = _loss_batch(kitti_root, **LOSS_CASES[case])
    assert batch["reg_mask"].sum() > 0 and batch["rotbin"].dtype == np.int32
    lkw = _loss_kw(cfg)
    touts = [{k: torch.tensor(v, requires_grad=True) for k, v in o.items()}
             for o in outs]
    tl, tstats = ddd_loss(touts, {k: torch.as_tensor(v)
                                  for k, v in batch.items()},
                          DddLossConfig(**lkw))
    tl.backward()
    tstats = {k: v.detach() for k, v in tstats.items()}
    with jax.enable_x64(True):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def fn(o):
            loss, stats = jddd.ddd_loss(o, jb, jddd.DddLossConfig(**lkw))
            return loss, stats
        (jl, jstats), jgrad = jax.value_and_grad(fn, has_aux=True)(
            [{k: jnp.asarray(v) for k, v in o.items()} for o in outs])
        jstats = {k: float(v) for k, v in jstats.items()}
        jgrad = jax.tree.map(np.asarray, jgrad)
    assert set(tstats) == set(jstats) == {"loss", "hm_l", "dep_l", "dim_l",
                                          "rot_l", "wh_l", "off_l"}
    for k in jstats:
        np.testing.assert_allclose(tstats[k].item(), jstats[k], rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    for s, (to, jo) in enumerate(zip(touts, jgrad)):
        assert set(to) == set(cfg.heads)
        for k, t in to.items():
            g = np.zeros_like(jo[k]) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(g, jo[k], rtol=1e-9, atol=1e-12,
                                       err_msg=f"stack {s} {k}")
    assert (tstats["wh_l"].item() > 0) == cfg.reg_bbox
    assert (tstats["off_l"].item() > 0) == cfg.reg_offset
    assert (tstats["rot_l"].item() > 0) == (cfg.rot_weight > 0)


def test_depth_transform_is_f32_at_least():
    from centerpoly_tpu_torch.losses.ddd import ddd_depth_transform
    x = torch.tensor([-3.0, 0.0, 2.5])
    got = ddd_depth_transform(x.bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), 1 / (1 / (1 + np.exp(-x.bfloat16().float().numpy()))
                          + 1e-6) - 1, rtol=1e-6)
    assert ddd_depth_transform(x.double()).dtype == torch.float64


def _child_env():
    """A child process's environment: no PYTHONPATH, and torch on this
    worker's share of the cores (a child would start one thread a core,
    and beside the other pytest workers' threads run many times slower)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    return env


_RANK = """
import sys
import torch
import torch.distributed as dist
from centerpoly_tpu_torch.losses import DddLossConfig, ddd_loss
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
d = torch.load(path)
outs = [{k: v.clone().requires_grad_(True) for k, v in o.items()}
        for o in d["outs"][rank]]
loss, stats = ddd_loss(outs, d["batch"][rank], DddLossConfig(**d["cfg"]),
                       group=dist.group.WORLD)
loss.backward()
torch.save({"loss": loss.detach(),
            "stats": {k: v.detach() for k, v in stats.items()},
            "grads": [{k: v.grad for k, v in o.items()} for o in outs]},
           f"{path}.{rank}")
dist.destroy_process_group()
"""


def test_loss_over_two_ranks_sums_to_the_global_batch(kitti_root, tmp_path):
    """Two gloo ranks, one sample each; rank 1's sample has no selected
    row (masks and bins zeroed), so its residual and regression terms are
    0 over the global counts.  The ranks' losses sum to the one-process
    loss of the batch and their gradients are its gradients."""
    from centerpoly_tpu_torch.train.mesh import free_port
    cfg, batch, outs = _loss_batch(kitti_root)
    for k in ("reg_mask", "rot_mask", "rotbin"):
        batch[k][1] = 0
    lkw = _loss_kw(cfg)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    touts = [{k: torch.tensor(v, requires_grad=True) for k, v in o.items()}
             for o in outs]
    ref, ref_stats = ddd_loss(touts, tb, DddLossConfig(**lkw))
    ref.backward()
    ref, ref_stats = ref.detach(), {k: v.detach()
                                    for k, v in ref_stats.items()}
    path = str(tmp_path / "inputs.pt")
    torch.save({"cfg": lkw,
                "batch": [{k: v[r:r + 1] for k, v in tb.items()}
                          for r in range(2)],
                "outs": [[{k: v.detach()[r:r + 1] for k, v in o.items()}
                          for o in touts] for r in range(2)]}, path)
    env = _child_env()
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port,
                               path], cwd=ROOT, env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    ranks = [torch.load(f"{path}.{r}") for r in range(2)]
    got = sum(float(r["loss"]) for r in ranks)
    np.testing.assert_allclose(got, ref.item(), rtol=1e-12)
    for k in ref_stats:
        np.testing.assert_allclose(
            sum(float(r["stats"][k]) for r in ranks), ref_stats[k].item(),
            rtol=1e-12, atol=1e-15, err_msg=k)
    for s, o in enumerate(touts):
        for k, t in o.items():
            g = torch.cat([r["grads"][s][k] for r in ranks])
            np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-12,
                                       atol=1e-15, err_msg=f"{s} {k}")


# -- the decode and the geometry --------------------------------------------

def _distinct(rng, *shape):
    n = int(np.prod(shape))
    return ((rng.permutation(n) + 1.0) / (n + 1)).reshape(shape).astype(
        np.float32)


def _ddd_maps(seed, b=2, h=16, w=40):
    rng = np.random.RandomState(seed)
    return {"heat": _distinct(rng, b, h, w, 3),
            "rot": rng.randn(b, h, w, 8).astype(np.float32),
            "depth": (1 + 30 * rng.rand(b, h, w, 1)).astype(np.float32),
            "dim": (1 + rng.rand(b, h, w, 3)).astype(np.float32),
            "wh": (4 + 20 * rng.rand(b, h, w, 2)).astype(np.float32),
            "reg": rng.rand(b, h, w, 2).astype(np.float32)}


@pytest.mark.parametrize("parts", [("wh", "reg"), ("wh",), ("reg",), ()],
                         ids=["wh_reg", "wh", "reg", "none"])
def test_ddd_decode_matches_jax(parts):
    maps = _ddd_maps(len(parts))
    main = ("heat", "rot", "depth", "dim")
    opt = {k: maps[k] for k in parts}
    got = tdec.ddd_decode(*(torch.from_numpy(maps[k]) for k in main),
                          **{k: torch.from_numpy(v) for k, v in opt.items()},
                          k=20).numpy()
    ref = np.asarray(jdec.ddd_decode(
        *(jnp.asarray(maps[k]) for k in main),
        **{k: jnp.asarray(v) for k, v in opt.items()}, k=20))
    assert got.shape == (2, 20, 18 if "wh" in parts else 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_geometry_matches_jax():
    rng = np.random.RandomState(5)
    rot = rng.randn(40, 8).astype(np.float32)
    rot[:3, 3] = 0.0                    # cos 0: arctan2's quadrant
    rot[3:6, 3] = -1.0
    np.testing.assert_array_equal(tgeo.get_alpha(rot), jgeo.get_alpha(rot))
    np.testing.assert_array_equal(DEFAULT_CALIB, jtask.DEFAULT_CALIB)
    for _ in range(10):
        pt = rng.rand(2) * [1242, 375]
        depth, alpha = rng.uniform(2, 60), rng.uniform(-np.pi, np.pi)
        dim = rng.uniform(0.5, 4, 3)
        np.testing.assert_array_equal(
            tgeo.unproject_2d_to_3d(pt, depth, DEFAULT_CALIB),
            jgeo.unproject_2d_to_3d(pt, depth, DEFAULT_CALIB))
        loc, ry = tgeo.ddd2locrot(pt, alpha, dim, depth, DEFAULT_CALIB)
        jloc, jry = jgeo.ddd2locrot(pt, alpha, dim, depth, DEFAULT_CALIB)
        np.testing.assert_array_equal(loc, jloc)
        assert ry == jry and -np.pi <= ry <= np.pi
        box = tgeo.compute_box_3d(dim, loc, ry)
        np.testing.assert_array_equal(box, jgeo.compute_box_3d(dim, loc, ry))
        np.testing.assert_array_equal(
            tgeo.project_to_image(box, DEFAULT_CALIB),
            jgeo.project_to_image(box, DEFAULT_CALIB))
    for a in (3.0, -3.0, 0.5):
        assert tgeo.alpha2rot_y(a, 1200.0, 604.0, 707.0) == \
            jgeo.alpha2rot_y(a, 1200.0, 604.0, 707.0)


@pytest.mark.parametrize("with_wh", [True, False], ids=["wh", "no_wh"])
def test_post_processes_match_jax(with_wh):
    maps = _ddd_maps(7)
    opt = {"wh": maps["wh"]} if with_wh else {}
    dets = tdec.ddd_decode(
        *(torch.from_numpy(maps[k]) for k in ("heat", "rot", "depth", "dim")),
        reg=torch.from_numpy(maps["reg"]),
        **{k: torch.from_numpy(v) for k, v in opt.items()}, k=30).numpy()
    c = [np.array([621.0, 187.5], np.float32)] * 2
    s = [np.array([1242.0, 375.0], np.float32)] * 2
    got2 = ddd_post_process_2d(dets.copy(), c, s, (16, 40), 3)
    ref2 = jtask.ddd_post_process_2d(dets.copy(), c, s, (16, 40), 3)
    for g, r in zip(got2, ref2):
        assert set(g) == set(r) == {1, 2, 3}
        for j in g:
            np.testing.assert_array_equal(g[j], r[j])
            assert g[j].shape[1] == (10 if with_wh else 8)
    got3 = ddd_post_process_3d(got2, [DEFAULT_CALIB])
    ref3 = jtask.ddd_post_process_3d(ref2, [DEFAULT_CALIB])
    for g, r in zip(got3, ref3):
        for j in g:
            np.testing.assert_array_equal(g[j], r[j])
            assert g[j].shape[1] == 13
            if not with_wh:                 # point boxes at the centres
                np.testing.assert_array_equal(g[j][:, 1], g[j][:, 3])


# -- the detector ------------------------------------------------------------

DKW = dict(KITTI, arch="res_18", input_h=H, input_w=W, head_conv=HEAD_CONV,
           K=16, mixed_precision=False)
FRAME_HW = (96, 320)


@pytest.fixture(scope="module")
def variables():
    return jax_variables("res_18", HEADS, HEAD_CONV, H, W, seed=8)[1]


@pytest.fixture
def jax_env(monkeypatch):
    """As tests/test_torch_detector.py: the JAX Config's DCN env var
    starts unset and is handed back unset; no host pre-shrink."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    monkeypatch.setattr(jdet.BaseDetector, "_shrink_for_send",
                        lambda self, image, trans, h, w: (image, trans))
    yield
    JConfig(**DKW)


def _frame(seed=11):
    return np.random.RandomState(seed).randint(0, 256, (*FRAME_HW, 3),
                                               dtype=np.uint8)


def _rows_sorted(rows):
    """A class's rows in one order: by score, then by the box's x0 (rows
    tied in score are held as a set)."""
    rows = np.asarray(rows, np.float64).reshape(-1, 13)
    return rows[np.lexsort((np.round(rows[:, 1], 1), -rows[:, -1]))]


def _same_rows(got, ref, width=13) -> int:
    """The same rows a class: score within 1e-4, every other column
    within 1e-3 relative + 1e-3 (the depth 1 / sigmoid - 1 and the
    lifted location amplify the heads' f32 differences)."""
    assert set(got) == set(ref) == {1, 2, 3}
    n = 0
    for j in ref:
        g, r = _rows_sorted(got[j]), _rows_sorted(ref[j])
        assert g.shape == r.shape, (j, g.shape, r.shape)
        n += len(r)
        np.testing.assert_allclose(g[:, -1], r[:, -1], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g[:, :-1], r[:, :-1], rtol=1e-3,
                                   atol=1e-3)
    return n


@pytest.mark.parametrize("extra", [{}, {"reg_bbox": False}],
                         ids=["default", "no_reg_bbox"])
def test_detector_matches_jax(jax_env, variables, extra):
    kw = dict(DKW, **extra)
    v = variables
    if extra:
        v = jax_variables("res_18", Config(**kw).heads, HEAD_CONV, H, W,
                          seed=8)[1]
    frames = [_frame(11), _frame(12)]
    jd = jdet.create_detector(JConfig(**kw), v)
    port = create_detector(Config(**kw), v, device="cpu")
    assert isinstance(port, DddDetector) and not port.flip_tta
    got = port.run(frames[0])
    ref = jd.run(frames[0])
    assert set(got) == set(ref)
    assert _same_rows(got["results"], ref["results"]) > 0
    for rows in got["results"].values():
        if len(rows):
            assert (rows[:, -1] > 0.2).all()            # peak_thresh
            if extra:                                   # point boxes
                np.testing.assert_array_equal(rows[:, 1], rows[:, 3])
    batch = port.run_batch(frames)
    jbatch = jd.run_batch(frames)
    for b, jb in zip(batch, jbatch):
        _same_rows(b["results"], jb["results"])
    for j in got["results"]:
        np.testing.assert_allclose(batch[0]["results"][j],
                                   got["results"][j], rtol=1e-4, atol=1e-3)
    for g, r in zip(port.run_stream(iter(frames), depth=2), batch):
        for j in g:
            np.testing.assert_allclose(g[j], r["results"][j], rtol=1e-4,
                                       atol=1e-3)


def test_flip_test_is_a_no_op(variables):
    """--flip_test runs a batch of 1 and gives the plain results."""
    plain = create_detector(Config(**DKW), variables, device="cpu")
    flip = create_detector(Config(**DKW, flip_test=True), variables,
                           device="cpu")
    batches = []
    hook = flip.model.register_forward_pre_hook(
        lambda mod, args: batches.append(args[0].shape[0]))
    got = flip.run(_frame())["results"]
    flip.run_batch([_frame(), _frame(12)])
    hook.remove()
    assert batches == [1, 2]
    ref = plain.run(_frame())["results"]
    for j in ref:
        np.testing.assert_array_equal(got[j], ref[j])


def test_debug_view_cuts_on_the_score_and_draws_the_box(variables,
                                                        monkeypatch):
    """Under --debug a ddd row [alpha, bbox 4, dim 3, location 3,
    rotation_y, score] is kept where its score (the last column) is above
    vis_thresh, and drawn as its box, columns 1-4: the box's corners take
    the class colour on the frame."""
    from centerpoly_tpu_torch.utils.debugger import Debugger
    drawn = []
    add = Debugger.add_coco_bbox

    def record(self, bbox, cat, conf=1.0, show_txt=True, img_id="default"):
        drawn.append((np.asarray(bbox, np.float64), int(cat), float(conf)))
        return add(self, bbox, cat, conf, show_txt=False, img_id=img_id)

    monkeypatch.setattr(Debugger, "add_coco_bbox", record)
    frame = _frame()
    rows = create_detector(Config(**DKW), variables,
                           device="cpu").run(frame)["results"]
    scores = np.sort([r[-1] for j in rows for r in rows[j]])
    thresh = float(scores[len(scores) // 2])    # half the rows are cut
    det = create_detector(Config(**DKW, debug=1, vis_thresh=thresh),
                          variables, device="cpu")
    assert det.run(frame)["results"].keys() == rows.keys()
    want = sorted((tuple(r[1:5]), j - 1, float(r[-1]))
                  for j in rows for r in rows[j] if r[-1] > thresh)
    got = sorted((tuple(b.astype(np.float32)), c, s) for b, c, s in drawn)
    assert 0 < len(want) < len(scores) and got == want
    img = det.debugger.imgs["detections"]
    for (x0, y0, x1, y1), cat, _ in want:
        color = det.debugger.colors[cat % len(det.debugger.colors)]
        for x, y in ((x0, y0), (x1, y1)):
            x, y = int(x), int(y)
            if 0 <= x < FRAME_HW[1] and 0 <= y < FRAME_HW[0]:
                assert (img[y, x] == color).all(), (x, y)


def test_scale_half_keeps_the_rows_where_jax_moves_them(jax_env, variables):
    """At test_scales (0.5,): JAX folds the scale into the warp but maps
    the rows back with the unscaled c and s, so its rows move from its
    scale-1 rows; the port warps each scale as scale 1, so its rows are
    its scale-1 rows, which equal JAX's scale-1 rows."""
    frame = _frame()
    one = dict(DKW)
    half = dict(DKW, test_scales=(0.5,))
    ref1 = jdet.create_detector(JConfig(**one), variables).run(frame)
    ref5 = jdet.create_detector(JConfig(**half), variables).run(frame)
    got1 = create_detector(Config(**one), variables, device="cpu").run(frame)
    got5 = create_detector(Config(**half), variables, device="cpu").run(frame)
    _same_rows(got1["results"], ref1["results"])
    for j in got1["results"]:
        np.testing.assert_array_equal(got5["results"][j],
                                      got1["results"][j])
    moved = False
    for j in ref1["results"]:
        a, b = (_rows_sorted(r["results"][j]) for r in (ref1, ref5))
        moved |= a.shape != b.shape or not np.allclose(a, b, atol=1.0)
    assert moved


# -- one train step ----------------------------------------------------------

def test_train_step_matches_jax(monkeypatch, kitti_root):
    """One DLA-34 ddd step (64x192, batch 2, aug_ddd 0) of each package in
    f64 from the same random weights: each loss part within 4x the port's
    own floor (+1e-5 relative), the parameters after Adam within
    2 lr + 1e-6, each gradient within 4x its floor + 1e-3 in relative L2,
    the BatchNorm statistics within rtol 1e-4, atol 4x floor + 1e-5."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    cfg = Config(**KITTI, input_h=H, input_w=W, head_conv=HEAD_CONV,
                 aug_ddd=0.0)
    meta = KittiMeta(kitti_root)
    sampler = DddSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    host = next(iter(Loader(sampler, 2, 2, shuffle=False)))
    assert host["reg_mask"].sum() >= 2 and host["rotbin"].sum() > 0
    variables = f64(jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=3)[1])
    jstats, jgrads, jafter = jax_step_f64("dla_34", HEADS, HEAD_CONV, (H, W),
                                          LR, {}, variables, host,
                                          task="ddd")
    net = port_model(variables, HEADS, HEAD_CONV).double()
    batch = port_batch_f64(host)
    stat_floor, grad_floor, buf_floor = self_sensitivity(
        net, batch, DddLossConfig(), ddd_loss)
    st = tstate.create_train_state(net, base_lr=LR)
    st, stats = make_train_step(DddLossConfig(), ddd_loss)(st, batch)
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


# -- the CLIs and the evaluator ----------------------------------------------

def _tree(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if not f.startswith("stats_")}


def test_main_and_test_on_a_kitti_fixture(tmp_path, kitti_root):
    """`main ddd` for one epoch of 2 steps with validation (on the val
    loss, as in JAX), then test.py on its model_best: KittiMeta writes
    the rows and runs the native evaluator against label_2.  The KITTI
    files JAX's writer makes of the same results are byte-equal, and
    JAX's run_kitti_eval on them gives the same numbers."""
    common = ["ddd", "--dataset", "kitti", "--data_dir", kitti_root,
              "--save_dir", str(tmp_path / "exp"), "--input_h", "64",
              "--input_w", "192", "--head_conv", "16", "--K", "20",
              "--peak_thresh", "0.1", "--device", "cpu"]
    tr = tmain.main(common + ["--batch_size", "2", "--num_workers", "0",
                              "--num_epochs", "1", "--val_intervals", "1"])
    assert tr.state.step == 2 and tr.cfg.aug_ddd == 0.5
    assert np.isfinite(tr.best) and tr.best < 0      # -val_loss
    save_dir = tmp_path / "exp" / "kitti" / "ddd" / "default"
    assert (save_dir / "model_best.pth").exists()
    out = ttest.main(common + ["--load_model", str(save_dir / "model_best.pth"),
                               "--dcn_kernel", "off"])
    assert out["frames"] == SPLITS["val"]
    rows = [r for per in out["results"].values() for r in per.values()
            if len(r)]
    assert rows and all(r.shape[1] == 13 and np.isfinite(r).all()
                        for r in rows)
    assert out["ap"] is not None and set(out["ap"]) <= {"car", "pedestrian",
                                                        "cyclist"}
    res_dir = save_dir / "results"
    JDATASETS["kitti"](kitti_root).write_kitti_results(
        out["results"], str(tmp_path / "jax"))
    assert _tree(str(res_dir)) == _tree(str(tmp_path / "jax"))
    gt_dir = os.path.join(kitti_root, "kitti", "training", "label_2")
    assert jnative.run_kitti_eval(gt_dir, str(tmp_path / "jax")) == out["ap"]


def test_gt_as_results_scores_ap_100(tmp_path):
    """A fixture with 41+ objects a class (the evaluator samples precision
    at 41 recall points): its label files read back as result rows
    score AP 100 in detection, BEV, 3D and AOS, in the port's evaluator
    and JAX's."""
    root = write_kitti3d_fixture(str(tmp_path), {"val": 40}, 1,
                                 max_objects=6)
    names = {v: k for k, v in KITTI_CATEGORIES.items()}
    meta = KittiMeta(root)
    gt_dir = os.path.join(root, "kitti", "training", "label_2")
    results = {}
    for img_id in CocoPolyAnnotations(meta.annot_path("val")).get_img_ids():
        per = {1: [], 2: [], 3: []}
        for line in open(os.path.join(gt_dir, f"{img_id:06d}.txt")):
            p = line.split()
            if names[p[0]] in per:
                per[names[p[0]]].append([float(v) for v in p[3:15]] + [1.0])
        results[img_id] = {c: np.asarray(v, np.float32).reshape(-1, 13)
                           for c, v in per.items()}
    assert min(sum(len(r[c]) for r in results.values())
               for c in (1, 2, 3)) >= 41
    got = meta.run_eval(results, str(tmp_path / "port"))
    ref = JDATASETS["kitti"](root).run_eval(results, str(tmp_path / "jax"))
    assert got == ref
    assert set(got) == {"car", "pedestrian", "cyclist"}
    for per in got.values():
        for metric in ("detection", "bev", "3d", "aos"):
            assert per[metric] == [100.0, 100.0, 100.0], per


_DDD_WITHOUT_PIL_CV2_JAX = """
import sys
sys.modules["PIL"] = sys.modules["cv2"] = sys.modules["jax"] = None
from centerpoly_tpu_torch import main, test
from centerpoly_tpu_torch.data.fixture import write_kitti3d_fixture
root = write_kitti3d_fixture(sys.argv[1], {"train": 2, "val": 2}, 0)
args = ["ddd", "--dataset", "kitti", "--data_dir", root, "--save_dir",
        root + "/exp", "--input_h", "64", "--input_w", "192", "--head_conv",
        "16", "--K", "8", "--device", "cpu"]
main.main(args + ["--batch_size", "2", "--num_workers", "0",
                  "--num_epochs", "1", "--val_intervals", "1",
                  "--aug_ddd", "1"])
out = test.main(args + ["--peak_thresh", "0"])
assert out["ap"] is not None and out["frames"] == 2, out
mods = ("centerpoly_tpu_torch.infer.task_detectors",
        "centerpoly_tpu_torch.data.ddd_sampler",
        "centerpoly_tpu_torch.losses.ddd", "centerpoly_tpu_torch.geometry.ddd")
assert all(m in sys.modules for m in mods)
bad = [m for m in sys.modules if m.startswith(("jax.", "jaxlib", "flax"))
       or m == "centerpoly_tpu" or m.startswith("centerpoly_tpu.")]
assert not bad, bad
print("AP", out["ap"])
"""


def test_ddd_path_needs_no_pil_cv2_or_jax(tmp_path):
    """`main ddd` (with aug_ddd 1) and test.py on a KITTI fixture, with
    PIL, cv2 and JAX unimportable: the frames read, the KITTI evaluator
    scores, and neither JAX nor the JAX package was imported."""
    env = _child_env()
    proc = subprocess.run([sys.executable, "-c", _DDD_WITHOUT_PIL_CV2_JAX,
                           str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "AP " in proc.stdout


# -- weights and config ------------------------------------------------------

def test_ddd_heads_round_trip_at_full_width():
    """The ddd heads at full width (head_conv 256; hm 3, dep 1, rot 8, dim
    3, wh 2, reg 2) map to the port's names and back through JAX's
    import_state_dict, every array exactly."""
    heads = dict(HEADS)
    assert heads == {"hm": 3, "dep": 1, "rot": 8, "dim": 3, "wh": 2,
                     "reg": 2}
    assert heads == dict(JConfig(**KITTI).heads)
    assert dict(Config(**KITTI, reg_bbox=False).heads) == dict(
        JConfig(**KITTI, reg_bbox=False).heads)
    _, variables = jax_dla_variables(heads, 256, 64, 64, seed=5)
    sd = weights.state_dict_from_jax(variables)
    own = port_model(variables, heads, 256).state_dict()
    for name, c in heads.items():
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


def test_config_fields_parse():
    cfg = Config.from_args(["ddd", "--dataset", "kitti", "--dep_weight", "2",
                            "--dim_weight", "0.5", "--rot_weight", "3",
                            "--no_reg_bbox", "--aug_ddd", "0.25",
                            "--peak_thresh", "0.3"])
    assert (cfg.dep_weight, cfg.dim_weight, cfg.rot_weight, cfg.reg_bbox,
            cfg.aug_ddd, cfg.peak_thresh) == (2.0, 0.5, 3.0, False, 0.25, 0.3)
    assert "wh" not in cfg.heads
    ref = JConfig(**KITTI)
    port = Config(**KITTI)
    for k in ("dep_weight", "dim_weight", "rot_weight", "reg_bbox",
              "aug_ddd", "peak_thresh", "num_classes", "input_h", "input_w",
              "mean", "std", "wh_weight", "off_weight", "hm_weight"):
        assert getattr(port, k) == getattr(ref, k), k
    jargs = JConfig.from_args(["ddd", "--dataset", "kitti", "--no_reg_bbox",
                               "--aug_ddd", "0.25", "--peak_thresh", "0.3"])
    assert (jargs.reg_bbox, jargs.aug_ddd, jargs.peak_thresh) == (
        cfg.reg_bbox, cfg.aug_ddd, cfg.peak_thresh)
