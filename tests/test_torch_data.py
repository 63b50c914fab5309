"""Training data of the PyTorch port against the JAX package.

* the host geometry (gaussian radius and splats, dense regression);
* the port's input warp, a separable two-tap gather in numpy, against
  `warp_axis_aligned` of both packages (the dense sampling-matrix form);
* `PolydetSampler`: the targets (hm, ind, reg_mask, poly, pseudo_depth,
  reg, wh, peak, freq_mask) equal to the JAX sampler's from the same
  frames and the same seed, and the input within the cv2 tolerance.  Both
  sides see the same pixels: the JAX sampler reads a PNG with cv2, the
  port the same array as `.npy`; or both take the missing-file noise;
* `Loader` batching and its error path.

Tolerances: the targets come from the same f32/f64 numpy arithmetic, so
rtol 1e-6 (atol 1e-6 for values near 0).  The warp against the matrix
form: atol 1e-3 on the 0-255 scale (two-tap sums against full-row dot
products in f32).  The sampler input against the JAX package's
cv2.warpAffine: cv2 rounds its output to uint8, an error uniform within
+-0.5 grey level, which normalisation by Cityscapes' std (~0.041) makes
ROUND = 0.048 at most and 0.024 on average; the colour aug scales it by
its three gains of at most 1.4 each.  So max ROUND * 1.4**3, mean
0.75 * ROUND.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.configs import Config as JConfig
from centerpoly_tpu.data.coco_poly import CocoPolyAnnotations as JAnnotations
from centerpoly_tpu.data.datasets import CityscapesMeta as JMeta
from centerpoly_tpu.data.sampler import PolydetSampler as JSampler
from centerpoly_tpu.geometry import affine as jaffine
from centerpoly_tpu.geometry import gaussian as jgauss
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (CityscapesMeta, CocoPolyAnnotations,
                                       Loader, PolydetSampler, stack_batch)
from centerpoly_tpu_torch.data.base_sampler import warp_axis_aligned_np
from centerpoly_tpu_torch.data.fixture import write_rect_fixture
from centerpoly_tpu_torch.geometry import affine as taffine
from centerpoly_tpu_torch.geometry import gaussian as tgauss

FRAME = (192, 384)          # fixture frames (H, W)
INPUT = (96, 192)           # network input (H, W)
ROUND = 0.5 / 255 / min(Config().std)
TARGETS = ("hm", "ind", "reg_mask", "poly", "pseudo_depth", "reg", "wh",
           "peak", "freq_mask")


# -- host geometry -----------------------------------------------------------

def test_gaussian_helpers_match_jax():
    for size in [(3, 5), (17.5, 40), (120, 33)]:
        assert tgauss.gaussian_radius(size) == jgauss.gaussian_radius(size)
    rng = np.random.RandomState(0)
    for center, radius in [((5, 7), 3), ((0, 0), 4), ((30, 18), 6)]:
        a, b = np.zeros((20, 32), np.float32), np.zeros((20, 32), np.float32)
        tgauss.splat_gaussian(a, center, radius)
        jgauss.splat_gaussian(b, center, radius)
        np.testing.assert_array_equal(a, b)
        a, b = a * 0, b * 0
        tgauss.splat_ellipse_gaussian(a, center, radius, radius + 3)
        jgauss.splat_ellipse_gaussian(b, center, radius, radius + 3)
        np.testing.assert_array_equal(a, b)
        hm = rng.rand(20, 32).astype(np.float32)
        value = rng.randn(4).astype(np.float32)
        a, b = np.zeros((20, 32, 4), np.float32), np.zeros((20, 32, 4),
                                                           np.float32)
        tgauss.draw_dense_reg(a, hm, center, value, radius)
        jgauss.draw_dense_reg(b, hm, center, value, radius)
        np.testing.assert_array_equal(a, b)


def test_affine_transform_points_matches_jax():
    trans = taffine.get_affine_transform(np.array([300.0, 150.0], np.float32),
                                         512.0, 0, (128, 64))
    np.testing.assert_array_equal(
        trans, jaffine.get_affine_transform(
            np.array([300.0, 150.0], np.float32), 512.0, 0, (128, 64)))
    pts = np.random.RandomState(1).rand(16, 2) * 500
    np.testing.assert_array_equal(taffine.affine_transform_points(pts, trans),
                                  jaffine.affine_transform_points(pts, trans))


@pytest.mark.parametrize("center,scale,flip", [
    ((192.0, 96.0), 384.0, False),      # the whole frame
    ((100.0, 60.0), 230.4, True),       # a crop, flipped
    ((370.0, 20.0), 537.6, False),      # zoomed out past the border
])
def test_warp_gather_matches_warp_axis_aligned(center, scale, flip):
    img = np.random.RandomState(2).randint(0, 256, (*FRAME, 3), np.uint8)
    if flip:
        img = img[:, ::-1, :]
    trans = taffine.get_affine_transform(np.array(center, np.float32), scale,
                                         0, INPUT[::-1])
    got = warp_axis_aligned_np(img, trans, INPUT)
    ref_j = np.asarray(jaffine.warp_axis_aligned(
        jnp.asarray(img.astype(np.float32)), trans, INPUT))
    ref_t = taffine.warp_axis_aligned(torch.from_numpy(
        img.astype(np.float32)), trans, INPUT).numpy()
    assert got.shape == (*INPUT, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, ref_t, rtol=0, atol=1e-3)


# -- the sampler -------------------------------------------------------------

@pytest.fixture(scope="module")
def frames_root(tmp_path_factory):
    """The rectangle fixture in both splits, plus the same frames as PNG
    under <root>/png/<split>/ with an annotation copy naming them."""
    cv2 = pytest.importorskip("cv2")
    root = write_rect_fixture(str(tmp_path_factory.mktemp("data")), 4, 3,
                              *FRAME, splits=("train", "val"))
    meta = CityscapesMeta(root)
    for split in ("train", "val"):
        with open(meta.annot_path(split)) as f:
            ann = json.load(f)
        os.makedirs(os.path.join(root, "png", split))
        for im in ann["images"]:
            arr = np.load(os.path.join(meta.img_dir(split), im["file_name"]))
            im["file_name"] = im["file_name"].replace(".npy", ".png")
            assert cv2.imwrite(os.path.join(root, "png", split,
                                            im["file_name"]), arr)
        with open(os.path.join(root, "png", f"{split}.json"), "w") as f:
            json.dump(ann, f)
    return root


def _samplers(root, split, png, **cfg_kw):
    kw = dict(input_h=INPUT[0], input_w=INPUT[1], **cfg_kw)
    meta = CityscapesMeta(root)
    port = PolydetSampler(Config(**kw), meta,
                          CocoPolyAnnotations(meta.annot_path(split)),
                          split=split, img_dir=meta.img_dir(split))
    jmeta = JMeta(root)
    if png:
        jann = JAnnotations(os.path.join(root, "png", f"{split}.json"))
        jdir = os.path.join(root, "png", split)
    else:
        jann = JAnnotations(jmeta.annot_path(split))
        jdir = jmeta.img_dir(split)
    return port, JSampler(JConfig(**kw), jmeta, jann, split=split,
                          img_dir=jdir)


def _assert_same(got, ref, split):
    for k in TARGETS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    d = np.abs(got["input"] - ref["input"])
    assert got["input"].shape == ref["input"].shape
    assert d.max() < ROUND * 1.4 ** 3 and d.mean() < 0.75 * ROUND, (
        d.max(), d.mean())
    if split != "train":
        for k in ("c", "s", "img_id", "out_width", "out_height"):
            np.testing.assert_array_equal(got["meta"][k], ref["meta"][k])
        np.testing.assert_allclose(got["meta"]["gt_det"], ref["meta"]["gt_det"],
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("split,rep,elliptical", [
    ("train", "polar", True),           # the paper's v2 run
    ("train", "cartesian", False),
    ("val", "polar", True),
])
def test_sampler_targets_match_jax(frames_root, split, rep, elliptical):
    port, ref = _samplers(frames_root, split, png=True, rep=rep,
                          elliptical_gt=elliptical)
    n_pos = 0
    for epoch in range(2):              # the rng runs on across epochs
        for i in range(len(port)):
            got, want = port(i), ref(i)
            _assert_same(got, want, split)
            n_pos += int(got["reg_mask"].sum())
    assert n_pos > 0


def test_sampler_missing_file_takes_the_same_noise(frames_root):
    """No image directory: both sides draw the frame from the image id's
    seeded noise at the annotated size."""
    port, ref = _samplers(frames_root, "train", png=False, rep="polar")
    port.img_dir = ref.img_dir = None
    for i in range(2):
        img = port._load_image(port.images[i])
        np.testing.assert_array_equal(img, ref._load_image(ref.images[i]))
        assert img.shape == (*FRAME, 3)
        _assert_same(port(i), ref(i), "train")


def test_sampler_png_without_cv2_raises(frames_root, monkeypatch):
    """Without cv2 a PNG frame still reads (utils/png.py), the pixels
    cv2.imread gives; only a JPEG frame raises, naming cv2."""
    cv2 = pytest.importorskip("cv2")
    port, _ = _samplers(frames_root, "train", png=False)
    port.img_dir = os.path.join(frames_root, "png", "train")
    port.coco = CocoPolyAnnotations(os.path.join(frames_root, "png",
                                                 "train.json"))
    name = port.coco.load_img(port.images[0])["file_name"]
    want = cv2.imread(os.path.join(port.img_dir, name))
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(port._load_image(port.images[0]), want)
    port(0)
    jpeg = os.path.join(port.img_dir, name.replace(".png", ".jpg"))
    with open(jpeg, "wb") as f:
        f.write(b"\xff\xd8")
    port.coco.load_img(port.images[0])["file_name"] = os.path.basename(jpeg)
    try:
        with pytest.raises(RuntimeError, match="needs cv2"):
            port(0)
    finally:
        os.remove(jpeg)


def test_sampler_undecodable_jpeg_takes_the_same_noise(frames_root,
                                                       tmp_path):
    """A JPEG that cv2 cannot decode: both sides draw the frame from the
    image id's seeded noise, as for a missing file."""
    pytest.importorskip("cv2")
    port, ref = _samplers(frames_root, "train", png=False, rep="polar")
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8")
    for sampler in (port, ref):
        sampler.img_dir = str(tmp_path)
        sampler.coco.load_img(sampler.images[0])["file_name"] = "bad.jpg"
    img = port._load_image(port.images[0])
    np.testing.assert_array_equal(img, ref._load_image(ref.images[0]))
    assert img.shape == (*FRAME, 3)


# -- the loader --------------------------------------------------------------

def test_loader_stacks_batches_in_order(frames_root):
    port, _ = _samplers(frames_root, "val", png=False)
    batches = list(Loader(port, len(port), 3, shuffle=False,
                          drop_last=False))
    assert [b["input"].shape for b in batches] == [(3, *INPUT, 3),
                                                   (1, *INPUT, 3)]
    assert batches[0]["hm"].shape == (3, INPUT[0] // 4, INPUT[1] // 4, 8)
    assert [m["img_id"] for b in batches for m in b["meta"]] == port.images
    one = stack_batch([port(1)])
    np.testing.assert_array_equal(one["poly"][0], batches[0]["poly"][1])


def test_loader_worker_processes_give_the_thread_path_batches(frames_root):
    """`main`'s default: worker processes (spawned) encode the batches;
    the val split has no augmentation, so they equal the thread path's."""
    port, _ = _samplers(frames_root, "val", png=False)
    want = list(Loader(port, len(port), 2, shuffle=False))
    got = list(Loader(port, len(port), 2, shuffle=False, num_workers=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in TARGETS + ("input",):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_raises_the_sampler_error():
    def bad(i):
        if i == 2:
            raise ValueError("bad sample")
        return {"x": np.full(2, i)}
    with pytest.raises(ValueError, match="bad sample"):
        list(Loader(bad, 4, 2, shuffle=False))
