"""Decode, affine geometry, post-process and soft-NMS of the PyTorch port
against the JAX package (f32, CPU).

Heatmaps are continuous random values, so top-K has no ties and its order
is defined on both sides; peaks per class outnumber K.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.geometry import affine as jaff
from centerpoly_tpu.infer.detector import \
    polydet_post_process as jax_post_process
from centerpoly_tpu.ops import decode as jdec
from centerpoly_tpu.ops.nms import soft_nms as jax_soft_nms
from centerpoly_tpu_torch.geometry import affine as taff
from centerpoly_tpu_torch.infer.detector import polydet_post_process
from centerpoly_tpu_torch.ops import decode as tdec
from centerpoly_tpu_torch.ops.nms import soft_nms
from centerpoly_tpu_torch.utils.timers import StageTimer


def _maps(seed=0, b=2, h=16, w=24, c=3, n2=8):
    rng = np.random.RandomState(seed)
    heat = rng.rand(b, h, w, c).astype(np.float32)
    polys = (rng.randn(b, h, w, n2) * 4).astype(np.float32)
    depth = rng.randn(b, h, w, 1).astype(np.float32)
    reg = rng.rand(b, h, w, 2).astype(np.float32)
    return heat, polys, depth, reg


def test_pseudo_nms_matches():
    heat = _maps()[0]
    np.testing.assert_array_equal(
        tdec.pseudo_nms(torch.from_numpy(heat)).numpy(),
        np.asarray(jdec.pseudo_nms(jnp.asarray(heat))))


def test_topk_heatmap_matches():
    heat = _maps(seed=1)[0]
    got = tdec.topk_heatmap(torch.from_numpy(heat), 10)
    ref = jdec.topk_heatmap(jnp.asarray(heat), 10)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=0)


@pytest.mark.parametrize("rep", ["cartesian", "polar", "polar_fixed"])
@pytest.mark.parametrize("with_reg", [True, False])
def test_polydet_decode_matches(rep, with_reg):
    heat, polys, depth, reg = _maps(seed=2)
    reg = reg if with_reg else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    got = tdec.polydet_decode(t(heat), t(polys), t(depth), t(reg), k=12,
                              rep=rep)
    ref = jdec.polydet_decode(j(heat), j(polys), j(depth), j(reg), k=12,
                              rep=rep)
    assert got.shape == (2, 12, 6 + 8 + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("center,scale,out,inv", [
    ((1024.0, 512.0), 2048.0, (1024, 512), False),
    ((1024.0, 512.0), 2048.0, (256, 128), True),
    ((100.0, 60.0), np.array([160.0, 96.0], np.float32), (160, 96), False),
])
def test_get_affine_transform_matches(center, scale, out, inv):
    np.testing.assert_array_equal(
        taff.get_affine_transform(center, scale, 0, out, inv=inv),
        jaff.get_affine_transform(center, scale, 0, out, inv=inv))


@pytest.mark.parametrize("src_hw,out_hw", [((128, 256), (64, 128)),
                                           ((50, 70), (64, 96))])
def test_warp_axis_aligned_matches(src_hw, out_hw):
    """Downscale (the inference path) and an upscale with borders."""
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (*src_hw, 3)).astype(np.float32)
    h, w = src_hw
    c = np.array([w / 2.0, h / 2.0], np.float32)
    trans = jaff.get_affine_transform(c, max(h, w) * 1.0, 0,
                                      (out_hw[1], out_hw[0]))
    ref = jaff.warp_axis_aligned(jnp.asarray(img), jnp.asarray(trans), out_hw)
    got = taff.warp_axis_aligned(torch.from_numpy(img), trans, out_hw)
    assert got.shape == (*out_hw, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)


def test_polydet_post_process_matches():
    heat, polys, depth, reg = _maps(seed=3, b=1)
    dets = np.asarray(jdec.polydet_decode(
        jnp.asarray(heat), jnp.asarray(polys), jnp.asarray(depth),
        jnp.asarray(reg), k=12))
    c = [np.array([300.0, 200.0], np.float32)]
    s = [640.0]
    got = polydet_post_process(dets.copy(), c, s, 16, 24, 3)
    ref = jax_post_process(dets.copy(), c, s, 16, 24, 3)
    assert got[0].keys() == ref[0].keys()
    for j in ref[0]:
        np.testing.assert_array_equal(np.asarray(got[0][j]),
                                      np.asarray(ref[0][j]))


@pytest.mark.parametrize("method", [0, 1, 2])
def test_soft_nms_matches(method):
    rng = np.random.RandomState(6)
    xy = rng.rand(30, 2) * 50
    dets = np.concatenate([xy, xy + 5 + rng.rand(30, 2) * 20,
                           rng.rand(30, 1)], 1).astype(np.float32)
    a, b = dets.copy(), dets.copy()
    np.testing.assert_array_equal(soft_nms(a, method=method),
                                  jax_soft_nms(b, method=method))
    np.testing.assert_array_equal(a, b)


def test_stage_timer_accumulates():
    t = StageTimer(torch.device("cpu"))
    with t.stage("a", device=True):   # off the card: on the host clock
        torch.zeros(1)
    with t.stage("b"):
        pass
    with t.stage("a"):
        pass
    times = t.read()
    assert set(times) == {"a", "b", "tot"}
    assert all(v >= 0 for v in times.values())
    assert times["a"] + times["b"] <= times["tot"]
