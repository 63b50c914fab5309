"""Every key of the port's `PolydetSampler` against the JAX package's
(CPU), the auxiliary targets included: border_hm, fg, and cat_spec_poly /
cat_spec_mask and dense_poly / dense_poly_mask (poly dropped) under their
flags.

* default, `--cat_spec_poly` and `--dense_poly`, each in cartesian and
  polar, never and always flipped, in train over two epochs (the rng
  draw for draw) and in val: every key bit-equal to JAX's but the input,
  which is within tests/test_torch_data.py's cv2 bound;
* `fg` from a 16-bit Cityscapes `gtFine_instanceIds` PNG beside the
  frame (JAX reads it with cv2, the port with utils/png.py), zeros where
  it is absent or the frame's name has no leftImg8bit; a PNG the numpy
  reader refuses raises; `resize_nearest` equal to cv2's INTER_NEAREST;
* training under the two flags: JAX's polydet loss fails at the polygon
  term (a shape mismatch, a missing `poly`); the port's raises a
  ValueError naming the flag at that point, in `main` too.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

cv2 = pytest.importorskip("cv2")

from centerpoly_tpu.configs import Config as JConfig  # noqa: E402
from centerpoly_tpu.data.coco_poly import \
    CocoPolyAnnotations as JAnnotations  # noqa: E402
from centerpoly_tpu.data.datasets import CityscapesMeta as JMeta  # noqa: E402
from centerpoly_tpu.data.sampler import PolydetSampler as JSampler  # noqa
from centerpoly_tpu.losses import polydet as jpolydet  # noqa: E402
from centerpoly_tpu_torch import main as tmain  # noqa: E402
from centerpoly_tpu_torch.configs import Config  # noqa: E402
from centerpoly_tpu_torch.data import (CityscapesMeta,  # noqa: E402
                                       CocoPolyAnnotations, PolydetSampler)
from centerpoly_tpu_torch.data.fixture import write_rect_fixture  # noqa
from centerpoly_tpu_torch.data.sampler import resize_nearest  # noqa: E402
from centerpoly_tpu_torch.losses import polydet as tpolydet  # noqa: E402

FRAME = (192, 384)
INPUT = (96, 200)           # output 24 x 50: 384 / 50 is not a whole scale
ROUND = 0.5 / 255 / min(Config().std)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Cityscapes-named PNG frames; frames 0 and 2 of each split have their
    16-bit gtFine_instanceIds PNG beside them (where the sampler looks),
    frames 1 and 3 have none there."""
    root = write_rect_fixture(str(tmp_path_factory.mktemp("cs")), 4, 5,
                              *FRAME, splits=("train", "val"), png=True)
    meta = CityscapesMeta(root)
    for split in ("train", "val"):
        with open(meta.annot_path(split)) as f:
            names = [im["file_name"] for im in json.load(f)["images"]]
        for i in (0, 2):
            inst = names[i].replace("leftImg8bit", "gtFine_instanceIds")
            shutil.copy(os.path.join(root, "gtFine", split, inst),
                        os.path.join(meta.img_dir(split), inst))
    return root


def _samplers(root, split, **kw):
    kw = dict(input_h=INPUT[0], input_w=INPUT[1], **kw)
    meta, jmeta = CityscapesMeta(root), JMeta(root)
    path = meta.annot_path(split)
    return (PolydetSampler(Config(**kw), meta, CocoPolyAnnotations(path),
                           split=split, img_dir=meta.img_dir(split)),
            JSampler(JConfig(**kw), jmeta, JAnnotations(path), split=split,
                     img_dir=jmeta.img_dir(split)))


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in ("input", "meta"):
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    d = np.abs(got["input"] - want["input"])
    assert d.max() < ROUND * 1.4 ** 3 and d.mean() < 0.75 * ROUND


FLAGS = {"default": {}, "cat_spec_poly": {"cat_spec_poly": True},
         "dense_poly": {"dense_poly": True}}


@pytest.mark.parametrize("flip", [0.0, 1.0], ids=["kept", "flipped"])
@pytest.mark.parametrize("rep", ["cartesian", "polar"])
@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_train_targets_match_jax(root, flag, rep, flip):
    port, ref = _samplers(root, "train", rep=rep, flip=flip,
                          **FLAGS[flag])
    fg_frames = border = 0
    for _ in range(2):                  # the rng runs on across epochs
        for i in range(len(port)):
            got, want = port(i), ref(i)
            _assert_same(got, want)
            fg_frames += int(got["fg"].any())
            border += int(got["border_hm"].max() == 1)
    assert fg_frames == 4 and border == 8    # frames 0 and 2, twice
    if flag == "dense_poly":
        assert "poly" not in got and got["dense_poly_mask"].any()
        assert got["dense_poly"].shape == (*got["hm"].shape[:2], 32)
    if flag == "cat_spec_poly":
        k = int(got["reg_mask"].sum())
        assert got["cat_spec_mask"][:k].sum() == 32 * k


def test_val_targets_match_jax(root):
    port, ref = _samplers(root, "val", rep="polar", cat_spec_poly=True,
                          dense_poly=True)
    for i in range(len(port)):
        got, want = port(i), ref(i)
        _assert_same(got, want)
        for k in ("c", "s", "img_id", "gt_det"):
            np.testing.assert_array_equal(got["meta"][k], want["meta"][k])


def test_fg_reads_the_instance_ids_as_cv2_reads_them(root, tmp_path):
    """fg of frame 0 is the nearest-resized instance-id map != 0; frame 1
    (no PNG beside it) and a `.npy` frame (no leftImg8bit in its name) get
    zeros; a 16-bit colour PNG, which utils/png.py refuses, raises."""
    port, _ = _samplers(root, "train")
    meta = CityscapesMeta(root)
    name = port.coco.load_img(port.images[0])["file_name"]
    inst = os.path.join(meta.img_dir("train"), name.replace(
        "leftImg8bit", "gtFine_instanceIds"))
    ids = cv2.imread(inst, -1)
    assert ids.dtype == np.uint16 and ids.max() >= 26000
    want = cv2.resize(ids.astype(np.float32), (INPUT[1] // 4, INPUT[0] // 4),
                      interpolation=cv2.INTER_NEAREST) != 0
    np.testing.assert_array_equal(port(0)["fg"][..., 0], want)
    assert not port(1)["fg"].any()
    npy = write_rect_fixture(str(tmp_path / "npy"), 2, 5, 96, 192)
    nport = PolydetSampler(Config(input_h=64, input_w=128),
                           CityscapesMeta(npy), CocoPolyAnnotations(
                               CityscapesMeta(npy).annot_path("train")),
                           img_dir=CityscapesMeta(npy).img_dir("train"))
    assert not nport(0)["fg"].any()
    saved = open(inst, "rb").read()
    try:
        cv2.imwrite(inst, np.zeros((*FRAME, 3), np.uint16))
        with pytest.raises(ValueError, match="bit depth 16"):
            port(0)
    finally:
        with open(inst, "wb") as f:
            f.write(saved)


@pytest.mark.parametrize("src,dst", [
    ((1024, 2048), (128, 256)), ((1024, 2048), (256, 512)),
    ((375, 1242), (96, 320)), ((192, 384), (24, 50)), ((37, 53), (91, 17)),
    ((5, 7), (16, 16)), ((100, 3), (33, 7))])
def test_resize_nearest_is_cv2s(src, dst):
    a = np.random.RandomState(0).randint(0, 65535, src).astype(np.float32)
    np.testing.assert_array_equal(
        resize_nearest(a, *dst),
        cv2.resize(a, dst[::-1], interpolation=cv2.INTER_NEAREST))


# -- training under the flags -------------------------------------------------

def _heads(sample, poly_channels, seed=0):
    """Random head maps of a batch of one for `sample`'s targets."""
    rng = np.random.RandomState(seed)
    h, w, c = sample["hm"].shape
    b = 1
    return {"hm": rng.randn(b, h, w, c).astype(np.float32),
            "poly": rng.randn(b, h, w, poly_channels).astype(np.float32),
            "pseudo_depth": rng.randn(b, h, w, 1).astype(np.float32),
            "reg": rng.randn(b, h, w, 2).astype(np.float32)}


@pytest.mark.parametrize("flag", ["cat_spec_poly", "dense_poly"])
def test_loss_under_the_flag_raises_where_jax_fails(root, flag):
    import jax.numpy as jnp
    port, ref = _samplers(root, "train", rep="polar", **FLAGS[flag])
    got, want = port(0), ref(0)
    heads = _heads(got, 8 * 32 if flag == "cat_spec_poly" else 32)
    keys = [k for k in got if k != "input"]
    jbatch = {k: jnp.asarray(np.asarray(want[k])[None]) for k in keys}
    jcfg = jpolydet.PolydetLossConfig(rep="polar")
    with pytest.raises((TypeError, KeyError)):
        jpolydet.polydet_loss([{k: jnp.asarray(v) for k, v in heads.items()}],
                              jbatch, jcfg)
    tbatch = {k: torch.from_numpy(np.asarray(got[k])[None]) for k in keys}
    with pytest.raises(ValueError, match=f"--{flag}"):
        tpolydet.polydet_loss([{k: torch.from_numpy(v)
                                for k, v in heads.items()}], tbatch,
                              tpolydet.PolydetLossConfig(rep="polar"))
    # and the default batch trains: the auxiliary keys ride along unread
    dport, _ = _samplers(root, "train", rep="polar")
    d = dport(0)
    loss, _ = tpolydet.polydet_loss(
        [{k: torch.from_numpy(v) for k, v in _heads(d, 32).items()}],
        {k: torch.from_numpy(np.asarray(d[k])[None]) for k in d
         if k != "input"}, tpolydet.PolydetLossConfig(rep="polar"))
    assert torch.isfinite(loss)


@pytest.mark.parametrize("flag", ["cat_spec_poly", "dense_poly"])
def test_main_under_the_flag_stops_at_the_first_step(tmp_path, flag):
    root = write_rect_fixture(str(tmp_path), 2, 1, 64, 128)
    with pytest.raises(ValueError, match=f"--{flag}"):
        tmain.main(["polydet", "--data_dir", root, "--save_dir",
                    str(tmp_path / "exp"), "--arch", "res_18",
                    "--input_h", "32", "--input_w", "64", "--head_conv", "8",
                    "--batch_size", "2", "--num_workers", "0",
                    "--num_epochs", "1", "--device", "cpu", f"--{flag}"])
