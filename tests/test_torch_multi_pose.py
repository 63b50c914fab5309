"""The multi_pose (human pose) task of the PyTorch port against the JAX
package's (CPU).

* `MultiPoseSampler` on a COCO person-keypoints fixture (PNG frames;
  joints with v = 0, joints outside the frame, a person with no visible
  joint) in train and val, forced flip, dense_hp, mse_loss and without
  the joint heads: every target equal to JAX's, bit for bit, the rng draw
  for draw over two epochs (the train split draws for aug_rot even at
  0); the input within tests/test_torch_ctdet.py's cv2 bound (`ROUND`);
* the rotated sampler (aug_rot 1, rotate 30) with the frames missing (both
  samplers warp the same seeded noise) and cv2 unimportable (JAX's
  sampler then warps with its own geometry/affine.py::warp_affine): the
  targets equal, the input within `WARP_TOL` normalised;
* `warp_affine_np` against JAX's `warp_affine` (rotations, scales, a
  shear) within `WARP_TOL_GREY` grey levels (f32 coordinates: a few ulps
  of a coordinate times a 255-level step), and against cv2.warpAffine's
  INTER_LINEAR within 0.75 grey levels at most and 0.3 on average (cv2
  rounds to uint8, and weighs in fixed point); `transform_preds` equal;
* `multi_pose_loss` under l1, sl1, dense_hp, mse_loss and without the
  joint heads, on two stacks, within rtol 1e-5;
* `topk_channel` equal; `multi_pose_decode` with and without hm_hp,
  hp_offset and reg within 1e-5, and JAX's snap case
  (tests/test_secondary_tasks.py::TestMultiPose::test_decode_snap);
* the flip merge of `MultiPoseDetector` on asymmetric head maps against
  JAX's, and `run` / `run_batch` against JAX's on the same weights with
  and without flip_test and with --nms (`soft_nms_39`): score within
  1e-3, box and joints within 1e-2 px;
* one DLA-34 multi_pose train step in f64 against `jax_step_f64`;
* `main multi_pose` (with the rotation) and `test.py` on the fixture;
* the multi_pose heads at full width through `state_dict_from_jax` and
  JAX's `import_state_dict`.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import (f64, jax_dla_variables, jax_step_f64,
                               port_batch_f64, port_model, self_sensitivity)

from centerpoly_tpu.configs import Config as JConfig
from centerpoly_tpu.data import CocoPolyAnnotations as JAnnotations
from centerpoly_tpu.data.datasets import CocoHpMeta as JCocoHpMeta
from centerpoly_tpu.data.multi_pose_sampler import (
    MultiPoseSampler as JSampler)
from centerpoly_tpu.geometry import affine as jaffine
from centerpoly_tpu.infer import detector as jdet
from centerpoly_tpu.infer import task_detectors as jtask
from centerpoly_tpu.losses import multi_pose as jmp
from centerpoly_tpu.ops import decode as jdec
from centerpoly_tpu.ops import nms as jnms
from centerpoly_tpu.train.checkpoint import flatten_params
from centerpoly_tpu.train.torch_import import import_state_dict
from centerpoly_tpu_torch import main as tmain
from centerpoly_tpu_torch import test as ttest
from centerpoly_tpu_torch import weights
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (DATASETS, SAMPLERS, CocoHpMeta,
                                       CocoPolyAnnotations, Loader,
                                       MultiPoseSampler)
from centerpoly_tpu_torch.data.fixture import write_keypoint_fixture
from centerpoly_tpu_torch.geometry import affine as taffine
from centerpoly_tpu_torch.infer.detector import DETECTORS, create_detector
from centerpoly_tpu_torch.infer.task_detectors import MultiPoseDetector
from centerpoly_tpu_torch.losses import MultiPoseLossConfig, multi_pose_loss
from centerpoly_tpu_torch.ops import decode as tdec
from centerpoly_tpu_torch.ops import nms as tnms
from centerpoly_tpu_torch.train import state as tstate
from centerpoly_tpu_torch.train.step import make_train_step

ROUND = 0.5 / 255 / min(Config().std)       # cv2's uint8 rounding, normalised
WARP_TOL_GREY = 1e-2                        # warp_affine_np vs JAX, 0-255
WARP_TOL = WARP_TOL_GREY / 255 / min(Config().std)   # the same, normalised
H, W, HEAD_CONV, LR = 64, 128, 32, 2e-4
HEADS = Config(task="multi_pose", dataset="coco_hp").heads


@pytest.fixture(scope="module")
def hp_root(tmp_path_factory):
    """A COCO keypoints fixture of PNG frames (both packages read the same
    pixels: cv2 in JAX's sampler, utils/png.py in the port's)."""
    return write_keypoint_fixture(str(tmp_path_factory.mktemp("coco_hp")),
                                  {"train": 4, "val": 2}, 0, 2 * H, 2 * W,
                                  png=True)


def _samplers(root, split, img_dir=None, **kw):
    kw = dict(task="multi_pose", dataset="coco_hp", input_h=H, input_w=W,
              **kw)
    meta, jmeta = CocoHpMeta(root), JCocoHpMeta(root)
    path = meta.annot_path(split)
    img_dir = img_dir or meta.img_dir(split)
    return (MultiPoseSampler(Config(**kw), meta, CocoPolyAnnotations(path),
                             split=split, img_dir=img_dir),
            JSampler(JConfig(**kw), jmeta, JAnnotations(path), split=split,
                     img_dir=img_dir))


def _same_targets(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in ("input", "meta"):
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the sampler -------------------------------------------------------------

SAMPLER_CASES = {
    "train": ("train", {}),
    "val": ("val", {}),
    "flip": ("train", {"flip": 1.0}),
    "dense_hp": ("train", {"dense_hp": True}),
    "mse_loss": ("train", {"mse_loss": True}),
    "no_joint_heads": ("train", {"hm_hp": False, "reg_hp_offset": False}),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(hp_root, case):
    split, kw = SAMPLER_CASES[case]
    port, ref = _samplers(hp_root, split, **kw)
    anns = port.coco.dataset["annotations"]
    if split == "train":
        assert any(sum(a["keypoints"][2::3]) == 0 for a in anns)
    n_pos = n_joints = 0
    for _ in range(2):                  # the rng runs on across epochs
        for i in range(len(port)):
            got, want = port(i), ref(i)
            _same_targets(got, want)
            d = np.abs(got["input"] - want["input"])
            assert d.max() < ROUND * 1.4 ** 3 and d.mean() < 0.75 * ROUND
            if split == "val":
                for k in ("c", "s", "img_id", "gt_det"):
                    np.testing.assert_array_equal(got["meta"][k],
                                                  want["meta"][k], err_msg=k)
                assert got["meta"]["gt_det"].shape[1] == 40
            n_pos += int(got["reg_mask"].sum())
            n_joints += int(got.get("hp_mask", got["reg_mask"]).sum())
    assert n_pos > 0 and n_joints > 0
    if kw.get("dense_hp"):
        assert "dense_hps" in got and "hps" not in got
    assert ("hm_hp" in got) == kw.get("hm_hp", True)


def test_sampler_person_without_visible_joints(hp_root):
    """The fixture's second person has no visible joint: reg_mask 0 and no
    joint targets, in both packages.  The sampler writes 0.9999 at its
    centre, but the centre gaussian drawn after it (a maximum) leaves 1
    there, in JAX's sampler and the reference's alike."""
    port, ref = _samplers(hp_root, "train", not_rand_crop=True, flip=0.0,
                          no_color_aug=True)
    ann = port.coco.dataset["annotations"][1]
    assert sum(ann["keypoints"][2::3]) == 0
    i = port.images.index(ann["image_id"])
    k = [a["id"] for a in port.coco.load_anns(ann["image_id"])].index(1)
    got, want = port(i), ref(i)
    _same_targets(got, want)
    assert got["reg_mask"][k] == 0 and got["hps_mask"][k].sum() == 0
    assert got["hm"].reshape(-1)[got["ind"][k]] == 1


def test_rotated_sampler_matches_jax(hp_root, tmp_path, monkeypatch):
    """aug_rot 1, rotate 30 on frames that the annotations name but the
    directory lacks (both samplers warp the same seeded noise), cv2
    unimportable (JAX's sampler then warps with its own warp_affine):
    the targets (blanked: hm 0.9999, masks 0) equal, the input within
    WARP_TOL."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    empty = tmp_path / "no_frames"
    empty.mkdir()
    port, ref = _samplers(hp_root, "train", img_dir=str(empty), aug_rot=1.0,
                          rotate=30.0)
    worst = 0.0
    for _ in range(2):
        for i in range(len(port)):
            got, want = port(i), ref(i)
            _same_targets(got, want)
            assert (got["hm"] == np.float32(0.9999)).all()
            assert got["reg_mask"].sum() == 0 and got["hps_mask"].sum() == 0
            worst = max(worst, float(np.abs(got["input"]
                                            - want["input"]).max()))
    assert worst < WARP_TOL, worst


def test_samplers_registered():
    assert SAMPLERS["multi_pose"] is MultiPoseSampler
    assert DATASETS["coco_hp"] is CocoHpMeta
    meta = CocoHpMeta("/data")
    assert meta.annot_path("val").endswith(
        "coco/annotations/person_keypoints_val2017.json")
    assert (meta.num_classes, meta.cat_ids, meta._valid_ids) == (1, {1: 0},
                                                                 [1])


# -- the warp ----------------------------------------------------------------

WARPS = {
    "rot30": (30.0, 160.0, (64, 64)),
    "rot-45_zoom": (-45.0, 100.0, (64, 64)),
    "rot17_shrink": (17.0, 300.0, (80, 48)),
    "rot90": (90.0, 160.0, (64, 96)),
    "axis_aligned": (0.0, 160.0, (64, 96)),
}


def _warp_cases():
    for name, (rot, scale, out) in WARPS.items():
        yield name, taffine.get_affine_transform(
            np.array([80.0, 60.0], np.float32), scale, rot, (out[1], out[0])
        ), out
    yield "shear", np.array([[0.5, 0.2, 3.0], [-0.1, 0.45, 5.0]]), (64, 64)


@pytest.mark.parametrize("name,trans,out", list(_warp_cases()),
                         ids=[c[0] for c in _warp_cases()])
def test_warp_affine_np_matches_jax_and_cv2(name, trans, out):
    img = np.random.RandomState(0).randint(0, 256, (120, 160, 3)).astype(
        np.uint8)
    got = taffine.warp_affine_np(img, trans, out)
    assert got.shape == (*out, 3) and got.dtype == np.float32
    ref = np.asarray(jaffine.warp_affine(jnp.asarray(img.astype(np.float32)),
                                         trans, out))
    np.testing.assert_allclose(got, ref, rtol=0, atol=WARP_TOL_GREY)
    cv2 = pytest.importorskip("cv2")
    cv = cv2.warpAffine(img, trans.astype(np.float32), (out[1], out[0]),
                        flags=cv2.INTER_LINEAR).astype(np.float32)
    d = np.abs(got - cv)
    assert d.max() < 0.75 and d.mean() < 0.3, (d.max(), d.mean())
    if name == "axis_aligned":
        from centerpoly_tpu_torch.data.base_sampler import warp_axis_aligned_np
        np.testing.assert_allclose(warp_axis_aligned_np(img, trans, out),
                                   got, rtol=0, atol=WARP_TOL_GREY)


def test_transform_preds_matches_jax():
    pts = np.random.RandomState(1).rand(20, 2).astype(np.float32) * 64
    for c, s, size in (([300.0, 200.0], 640.0, (128, 128)),
                       ([90.0, 60.0], np.array([200.0, 150.0]), (64, 32))):
        c = np.asarray(c, np.float32)
        got = taffine.transform_preds(pts, c, s, size)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jaffine.transform_preds(pts, c, s, size))


# -- the loss ----------------------------------------------------------------

LOSS_CASES = {
    "l1": {},
    "sl1": {"reg_loss": "sl1"},
    "dense_hp": {"dense_hp": True},
    "mse_loss": {"mse_loss": True},
    "no_joint_heads": {"hm_hp": False, "reg_hp_offset": False},
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_multi_pose_loss_matches_jax(hp_root, case):
    """Two stacks of random head maps on a train batch of 2."""
    kw = LOSS_CASES[case]
    cfg = Config(task="multi_pose", dataset="coco_hp", input_h=H, input_w=W,
                 **kw)
    meta = CocoHpMeta(hp_root)
    sampler = MultiPoseSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    batch = next(iter(Loader(sampler, 2, 2, shuffle=False)))
    rng = np.random.RandomState(4)
    oh, ow = cfg.output_h, cfg.output_w
    outs = [{k: (rng.randn(2, oh, ow, c) * (2.0 if k.startswith("hm")
                                             else 3.0)).astype(np.float32)
             for k, c in cfg.heads.items()} for _ in range(2)]
    lkw = {k: getattr(cfg, k) for k in (
        "hm_weight", "wh_weight", "off_weight", "hp_weight", "hm_hp_weight",
        "mse_loss", "reg_loss", "dense_hp", "hm_hp", "reg_hp_offset",
        "reg_offset")}
    jl, jstats = jmp.multi_pose_loss(
        [{k: jnp.asarray(v) for k, v in o.items()} for o in outs],
        {k: jnp.asarray(v) for k, v in batch.items()},
        jmp.MultiPoseLossConfig(**lkw))
    tl, tstats = multi_pose_loss(
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in outs],
        {k: torch.from_numpy(v) for k, v in batch.items()},
        MultiPoseLossConfig(**lkw))
    assert set(tstats) == set(jstats) == {"loss", "hm_l", "hp_l", "hm_hp_l",
                                          "hp_off_l", "wh_l", "off_l"}
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(tstats["hp_l"]) > 0
    assert (float(tstats["hm_hp_l"]) > 0) == cfg.hm_hp


# -- the decode --------------------------------------------------------------

def _distinct(rng, *shape, scale=1.0):
    n = int(np.prod(shape))
    return (scale * (rng.permutation(n) + 1.0) / (n + 1)).reshape(
        shape).astype(np.float32)


def test_topk_channel_matches_jax():
    heat = _distinct(np.random.RandomState(0), 2, 16, 24, 17)
    got = tdec.topk_channel(torch.from_numpy(heat), 10)
    ref = jdec.topk_channel(jnp.asarray(heat), 10)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (2, 17, 10)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _pose_maps(seed, b=2, h=24, w=32):
    rng = np.random.RandomState(seed)
    return {"heat": _distinct(rng, b, h, w, 1),
            "wh": (8 + 8 * rng.rand(b, h, w, 2)).astype(np.float32),
            "kps": (3 * rng.randn(b, h, w, 34)).astype(np.float32),
            "reg": rng.rand(b, h, w, 2).astype(np.float32),
            "hm_hp": _distinct(rng, b, h, w, 17, scale=0.3),
            "hp_offset": rng.rand(b, h, w, 2).astype(np.float32)}


@pytest.mark.parametrize("parts", [
    ("reg", "hm_hp", "hp_offset"), ("hm_hp",), ("reg",), ()],
    ids=["all", "hm_hp", "reg", "none"])
def test_multi_pose_decode_matches_jax(parts):
    maps = _pose_maps(len(parts))
    opt = {k: maps[k] for k in parts}
    got = tdec.multi_pose_decode(
        *(torch.from_numpy(maps[k]) for k in ("heat", "wh", "kps")),
        **{k: torch.from_numpy(v) for k, v in opt.items()}, k=12).numpy()
    ref = np.asarray(jdec.multi_pose_decode(
        *(jnp.asarray(maps[k]) for k in ("heat", "wh", "kps")),
        **{k: jnp.asarray(v) for k, v in opt.items()}, k=12))
    assert got.shape == (2, 12, 40)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if "hm_hp" in parts:
        plain = tdec.multi_pose_decode(
            *(torch.from_numpy(maps[k]) for k in ("heat", "wh", "kps")),
            reg=torch.from_numpy(maps["reg"]) if "reg" in parts else None,
            k=12).numpy()
        snapped = np.abs(plain[..., 5:39] - got[..., 5:39]) > 1e-6
        assert snapped.any() and not snapped.all()


def test_multi_pose_decode_snap():
    """JAX's case (tests/test_secondary_tasks.py): a regressed joint in
    the box snaps to the confident joint peak 1 px away."""
    b, h, w = 1, 32, 32
    hm = np.zeros((b, h, w, 1), np.float32)
    hm[0, 16, 16, 0] = 0.9
    wh = np.zeros((b, h, w, 2), np.float32)
    wh[0, 16, 16] = (20.0, 20.0)
    kps = np.zeros((b, h, w, 34), np.float32)
    kps[0, 16, 16, 0] = -3.0
    hm_hp = np.zeros((b, h, w, 17), np.float32)
    hm_hp[0, 16, 12, 0] = 0.8
    got = tdec.multi_pose_decode(torch.from_numpy(hm), torch.from_numpy(wh),
                                 torch.from_numpy(kps),
                                 hm_hp=torch.from_numpy(hm_hp), k=4).numpy()
    ref = np.asarray(jdec.multi_pose_decode(
        jnp.asarray(hm), jnp.asarray(wh), jnp.asarray(kps),
        hm_hp=jnp.asarray(hm_hp), k=4))
    assert got[0, 0, 5] == pytest.approx(12.5, abs=1e-4)
    assert got[0, 0, 6] == pytest.approx(16.5, abs=1e-4)
    # the other rows are tied zero peaks, which torch.topk and lax.top_k
    # order differently
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=0, atol=1e-5)


def test_soft_nms_39_matches_jax():
    rng = np.random.RandomState(2)
    dets = np.concatenate([rng.rand(30, 2) * 50, rng.rand(30, 2) * 50 + 50,
                           rng.rand(30, 1), rng.rand(30, 34)], 1).astype(
        np.float32)
    a, b = dets.copy(), dets.copy()
    np.testing.assert_array_equal(tnms.soft_nms_39(a), jnms.soft_nms_39(b))
    np.testing.assert_array_equal(a, b)


# -- the detector ------------------------------------------------------------

KW = dict(task="multi_pose", dataset="coco_hp", input_h=H, input_w=W,
          head_conv=HEAD_CONV, K=16, mixed_precision=False)


@pytest.mark.parametrize("parts", [("hm_hp", "reg_hp_offset"), ()],
                         ids=["joint_heads", "no_joint_heads"])
def test_flip_merge_matches_jax(parts):
    """The flip merge on random, asymmetric head maps of a doubled batch
    [originals(2); flipped(2)]: the decoded rows equal JAX's within 1e-5
    (a wrong axis or joint order gives other rows)."""
    kw = dict(KW, flip_test=True, hm_hp="hm_hp" in parts,
              reg_hp_offset="reg_hp_offset" in parts)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    rng = np.random.RandomState(7)
    maps = {k: (rng.randn(4, 16, 32, c) * 2).astype(np.float32)
            for k, c in cfg.heads.items()}
    jd = jtask.MultiPoseDetector.__new__(jtask.MultiPoseDetector)
    jd.cfg = jcfg
    jd._heads = lambda variables, images: {k: jnp.asarray(v)
                                           for k, v in maps.items()}
    ref = np.asarray(jd._process_device(None, None)[1])
    pd = MultiPoseDetector.__new__(MultiPoseDetector)
    pd.cfg = cfg
    got = pd._decode({k: torch.from_numpy(v).permute(0, 3, 1, 2)
                      for k, v in maps.items()}).numpy()
    assert got.shape == (2, 16, 40)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    no_flip = Config(**dict(kw, flip_test=False))
    pd.cfg = no_flip
    plain = pd._decode({k: torch.from_numpy(v[:2]).permute(0, 3, 1, 2)
                        for k, v in maps.items()}).numpy()
    assert np.abs(plain - got).max() > 1e-2


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


def _same_poses(got, ref) -> int:
    """The same rows under class 1: score within 1e-3, box and joints
    within 1e-2 px."""
    assert set(got) == set(ref) == {1}
    g, r = np.asarray(got[1]), np.asarray(ref[1])
    assert g.shape == r.shape and g.shape[1] == 39
    np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.delete(g, 4, 1), np.delete(r, 4, 1),
                               rtol=0, atol=1e-2)
    return len(r)


@pytest.mark.parametrize("extra", [
    {"dcn_kernel": "rowband:6"}, {"dcn_kernel": "rowband:6", "flip_test": True},
    {"dcn_kernel": "off", "nms": True}],
    ids=["rowband6", "flip_test", "off_nms"])
def test_detector_matches_jax(jax_env, variables, extra):
    frame = _frame()
    ref = jdet.create_detector(JConfig(**KW, **extra), variables).run(frame)
    port = create_detector(Config(**KW, **extra), variables, device="cpu")
    assert isinstance(port, MultiPoseDetector) and port.flip_tta
    batches = []
    hook = port.model.register_forward_pre_hook(
        lambda mod, args: batches.append(args[0].shape[0]))
    got = port.run(frame)
    hook.remove()
    assert batches == [2 if extra.get("flip_test") else 1]
    assert set(got) == set(ref)
    assert _same_poses(got["results"], ref["results"]) == 16
    batch = port.run_batch([frame, _frame(12)])
    np.testing.assert_allclose(batch[0]["results"][1], got["results"][1],
                               rtol=0, atol=1e-2)
    jbatch = jdet.create_detector(JConfig(**KW, **extra), variables
                                  ).run_batch([frame, _frame(12)])
    assert _same_poses(batch[1]["results"], jbatch[1]["results"]) == 16


def test_detector_registered_and_streams(variables):
    assert DETECTORS["multi_pose"] is MultiPoseDetector
    det = create_detector(Config(**KW), variables, device="cpu")
    frames = [_frame(s) for s in (11, 12)]
    refs = [det.run(f)["results"] for f in frames]
    for got, ref in zip(det.run_stream(iter(frames), depth=2), refs):
        np.testing.assert_array_equal(got[1], ref[1])


# -- one train step ----------------------------------------------------------

def test_train_step_matches_jax(monkeypatch, hp_root):
    """One DLA-34 multi_pose step (64x128, batch 2) of each package in
    f64 from the same random weights: each loss part within 4x the port's
    own floor (+1e-5 relative), the parameters after Adam within
    2 lr + 1e-6, each gradient within 4x its floor + 1e-3 in relative L2,
    the BatchNorm statistics within rtol 1e-4, atol 4x floor + 1e-5."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    cfg = Config(task="multi_pose", dataset="coco_hp", input_h=H, input_w=W,
                 head_conv=HEAD_CONV)
    meta = CocoHpMeta(hp_root)
    sampler = MultiPoseSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    host = next(iter(Loader(sampler, len(sampler), 2, shuffle=False)))
    assert host["reg_mask"].sum() >= 2 and host["hp_mask"].sum() > 0
    variables = f64(jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=3)[1])
    jstats, jgrads, jafter = jax_step_f64("dla_34", HEADS, HEAD_CONV, (H, W),
                                          LR, {}, variables, host,
                                          task="multi_pose")
    net = port_model(variables, HEADS, HEAD_CONV).double()
    batch = port_batch_f64(host)
    stat_floor, grad_floor, buf_floor = self_sensitivity(
        net, batch, MultiPoseLossConfig(), multi_pose_loss)
    st = tstate.create_train_state(net, base_lr=LR)
    st, stats = make_train_step(MultiPoseLossConfig(), multi_pose_loss)(
        st, batch)
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

def test_main_and_test_on_a_keypoint_fixture(tmp_path, hp_root):
    """`main multi_pose` with the rotation for one epoch of 2 steps with
    validation (on the val loss, as in JAX), then test.py on its
    model_best: CocoHpMeta scores the 39-column rows as boxes."""
    common = ["multi_pose", "--dataset", "coco_hp", "--data_dir", hp_root,
              "--save_dir", str(tmp_path / "exp"), "--input_h", "64",
              "--input_w", "64", "--head_conv", "16", "--K", "20",
              "--device", "cpu"]
    tr = tmain.main(common + ["--batch_size", "2", "--num_workers", "0",
                              "--num_epochs", "1", "--val_intervals", "1",
                              "--aug_rot", "1", "--rotate", "30"])
    assert tr.state.step == 2 and (tr.cfg.aug_rot, tr.cfg.rotate) == (1, 30)
    assert np.isfinite(tr.best) and tr.best < 0      # -val_loss
    save_dir = tmp_path / "exp" / "coco_hp" / "multi_pose" / "default"
    assert (save_dir / "model_best.pth").exists()
    out = ttest.main(common + ["--load_model", str(save_dir / "model_best.pth"),
                               "--dcn_kernel", "off"])
    assert out["frames"] == 2
    assert set(out["ap"]) == {"AP", "AP50", "AP75", "AR100", "APs", "APm",
                              "APl"}
    assert (save_dir / "coco_eval.json").exists()
    for per_class in out["results"].values():
        assert set(per_class) == {1}
        assert per_class[1].shape == (20, 39)
        assert np.isfinite(per_class[1]).all()


def test_coco_hp_eval_scores_the_box_columns(hp_root, tmp_path):
    """CocoHpMeta.run_eval scores a multi_pose row's first five columns:
    the val split's GT boxes at score 0.9 with 34 joint columns give AP 1,
    the AP of the same rows cut to 5 columns.  (JAX's CocoMeta.run_eval
    reshapes the 39-column rows to (-1, 5): it raises where a class's
    rows times 39 is no multiple of 5, as here, and mixes joints into
    boxes where it is.)"""
    meta = CocoHpMeta(hp_root)
    ann = CocoPolyAnnotations(meta.annot_path("val"))
    rng = np.random.RandomState(0)
    rows = {}
    for img_id in ann.get_img_ids():
        boxes = [[x, y, x + w, y + h, 0.9] for x, y, w, h in
                 (a["bbox"] for a in ann.load_anns(img_id))]
        rows[img_id] = {1: np.concatenate([np.asarray(boxes, np.float32),
                                           rng.rand(len(boxes), 34) * 100],
                                          1).astype(np.float32)}
    assert sum(len(r[1]) for r in rows.values()) % 5
    got = meta.run_eval(rows, str(tmp_path / "a"))
    assert got["AP"] == pytest.approx(1.0)
    five = meta.run_eval({i: {1: r[1][:, :5]} for i, r in rows.items()},
                         str(tmp_path / "b"))
    assert got == five
    if any(len(r[1]) % 5 for r in rows.values()):
        with pytest.raises(ValueError):
            JCocoHpMeta(hp_root).run_eval(rows, str(tmp_path / "c"))


# -- weights -----------------------------------------------------------------

def test_multi_pose_heads_round_trip_at_full_width():
    """The multi_pose heads at full width (head_conv 256; hm 1, wh 2, hps
    34, hm_hp 17, hp_offset 2, reg 2) map to the port's names and back
    through JAX's import_state_dict, every array exactly."""
    heads = dict(HEADS)
    assert heads == {"hm": 1, "wh": 2, "hps": 34, "hm_hp": 17,
                     "hp_offset": 2, "reg": 2}
    assert heads == dict(JConfig(task="multi_pose", dataset="coco_hp").heads)
    assert dict(Config(task="multi_pose", dataset="coco_hp", hm_hp=False,
                       reg_hp_offset=False).heads) == {
        "hm": 1, "wh": 2, "hps": 34, "reg": 2}
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


def test_config_fields_parse():
    cfg = Config.from_args(["multi_pose", "--dataset", "coco_hp",
                            "--hp_weight", "2", "--hm_hp_weight", "0.5",
                            "--dense_hp", "--no_hm_hp", "--no_reg_hp_offset",
                            "--aug_rot", "0.5", "--rotate", "20"])
    assert (cfg.hp_weight, cfg.hm_hp_weight, cfg.dense_hp, cfg.hm_hp,
            cfg.reg_hp_offset, cfg.aug_rot, cfg.rotate) == (
        2.0, 0.5, True, False, False, 0.5, 20.0)
    assert "hm_hp" not in cfg.heads and "hp_offset" not in cfg.heads
    assert Config.from_args(["exdet", "--dataset", "coco", "--agnostic_ex"]
                            ).heads["hm_t"] == 1
    ref = JConfig(task="multi_pose", dataset="coco_hp")
    port = Config(task="multi_pose", dataset="coco_hp")
    for k in ("hp_weight", "hm_hp_weight", "dense_hp", "hm_hp",
              "reg_hp_offset", "agnostic_ex", "aug_rot", "rotate",
              "num_classes", "input_h", "input_w", "mean", "std"):
        assert getattr(port, k) == getattr(ref, k), k
