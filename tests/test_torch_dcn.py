"""DCNv2 forward of the PyTorch port against the JAX package.

The port's plain version `deform_conv2d_ref` (what its wrapper computes on
a CPU tensor) is held against:
  * exact mode: centerpoly_tpu.models.deform_conv.deform_conv2d, the plain
    reference of the exact Pallas kernel (kernels/dcn_pallas.py; its
    interpret mode takes ~10 minutes, tests/test_dcn_pallas.py:4);
  * rowband:R: the row-band Pallas kernel itself in interpret mode, and
    its oracle deform_conv2d_rowband_ref;
  * halo:R: the halo Pallas kernel itself in interpret mode, and its
    oracle deform_conv2d_halo_ref.
Tolerance rtol 1e-4, atol 1e-5 in f32: that of tests/test_dcn_rowband.py
and tests/test_dcn_halo.py (same arithmetic, sums taken in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.kernels.dcn_halo import (deform_conv2d_halo,
                                             deform_conv2d_halo_ref)
from centerpoly_tpu.kernels.dcn_rowband import (deform_conv2d_rowband,
                                                deform_conv2d_rowband_ref)
from centerpoly_tpu.models import deform_conv as jdc
from centerpoly_tpu_torch.kernels import dcn, nvcc
from centerpoly_tpu_torch.models.deform_conv import (DCNv2, DeformConvBlock,
                                                     parse_dcn_kernel)

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(b=1, h=8, w=8, c=8, cout=8, seed=0, scale=1.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = (rng.randn(b, h, w, 18) * scale).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(b, h, w, 9)))).astype(np.float32)
    wt = (rng.randn(3, 3, c, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, off, mask, wt, bias


def _port(args, r=None, halo=None):
    return dcn.deform_conv2d_ref(*map(torch.from_numpy, args),
                                 max_offset_y=r, max_offset=halo).numpy()


def _edge_offsets(off, axis, sign):
    """Push every sample off one image edge: 12 px along `axis` (0 = y,
    1 = x) in direction `sign`."""
    off = off.copy()
    off[..., axis::2] = sign * 12.0
    return off


EXACT_CASES = {
    "random": lambda a: a,
    "integer": lambda a: (a[0], np.round(a[1]), *a[2:]),
    "zero": lambda a: (a[0], np.zeros_like(a[1]), *a[2:]),
    **{f"off_{n}": (lambda ax, s: lambda a: (a[0], _edge_offsets(a[1], ax, s),
                                             *a[2:]))(ax, s)
       for n, ax, s in (("bottom", 0, 1), ("top", 0, -1), ("right", 1, 1),
                        ("left", 1, -1))},
}


@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_exact_matches_jax(case):
    args = EXACT_CASES[case](_inputs(b=2, h=6, w=10, c=8, cout=5))
    ref = jdc.deform_conv2d(*map(jnp.asarray, args))
    np.testing.assert_allclose(_port(args), np.asarray(ref), **TOL)


@pytest.mark.parametrize("scale", [0.8, 3.0])  # within / beyond R
def test_rowband_matches_pallas_interpret(scale):
    args = _inputs(b=2, h=8, w=16, scale=scale)
    jargs = list(map(jnp.asarray, args))
    kernel = deform_conv2d_rowband(*jargs, 2, True)
    oracle = deform_conv2d_rowband_ref(*jargs, 2)
    got = _port(args, 2)
    np.testing.assert_allclose(got, np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("axis,sign", [(0, 1), (0, -1), (1, 1), (1, -1)])
def test_rowband_edges_match_oracle(axis, sign):
    x, off, mask, wt, bias = _inputs(h=6, w=6, scale=0.0)
    args = (x, _edge_offsets(off, axis, sign), mask, wt, bias)
    ref = deform_conv2d_rowband_ref(*map(jnp.asarray, args), 2)
    np.testing.assert_allclose(_port(args, 2), np.asarray(ref), **TOL)


def test_rowband_keeps_x_offsets_beyond_r_exact():
    x, off, mask, wt, bias = _inputs(h=6, w=16, scale=0.0)
    off[..., 0::2] = 0.3
    off[..., 1::2] = 5.2
    args = (x, off, mask, wt, bias)
    ref = jdc.deform_conv2d(*map(jnp.asarray, args))   # unclamped oracle
    np.testing.assert_allclose(_port(args, 2), np.asarray(ref), **TOL)


def test_halo_matches_pallas_interpret():
    """(1, 8, 8, 8), R = 2, offsets x1.5: some beyond R on both axes."""
    args = _inputs(scale=1.5)
    assert (np.abs(args[1][..., 0::2]) > 2).any()
    assert (np.abs(args[1][..., 1::2]) > 2).any()
    jargs = list(map(jnp.asarray, args))
    kernel = deform_conv2d_halo(*jargs, 2, True)
    oracle = deform_conv2d_halo_ref(*jargs, 2)
    got = _port(args, halo=2)
    np.testing.assert_allclose(got, np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


def _at_bound(off, axis, r):
    """Every offset of one axis exactly at +-r (by its sign), the other
    axis random."""
    off = off.copy()
    off[..., axis::2] = np.where(off[..., axis::2] > 0, r, -r)
    return off


HALO_EDGE_CASES = {
    "y_at_r": lambda o: _at_bound(o, 0, 2.0),
    "x_at_r": lambda o: _at_bound(o, 1, 2.0),
    "beyond_r": lambda o: o * 4,
    **{f"off_{n}": (lambda ax, s: lambda o: _edge_offsets(o, ax, s))(ax, s)
       for n, ax, s in (("bottom", 0, 1), ("top", 0, -1), ("right", 1, 1),
                        ("left", 1, -1))},
}


@pytest.mark.parametrize("case", sorted(HALO_EDGE_CASES))
def test_halo_edges_match_oracle(case):
    """Offsets exactly at +-R on one axis, far beyond R, and samples pushed
    off each image edge (clamped back to R inside it)."""
    x, off, mask, wt, bias = _inputs(h=6, w=7, scale=1.5)
    args = (x, HALO_EDGE_CASES[case](off), mask, wt, bias)
    ref = deform_conv2d_halo_ref(*map(jnp.asarray, args), 2)
    np.testing.assert_allclose(_port(args, halo=2), np.asarray(ref), **TOL)


def test_halo_zero_is_the_modulated_plain_conv():
    """halo:0 clamps every offset to 0: the output is the modulated 3x3
    conv, whatever the offsets."""
    x, off, mask, wt, bias = _inputs(h=6, w=7, scale=3.0)
    ref = deform_conv2d_halo_ref(*map(jnp.asarray, (x, off, mask, wt, bias)),
                                 0)
    plain = jdc.deform_conv2d(*map(jnp.asarray, (x, np.zeros_like(off), mask,
                                                 wt, bias)))
    got = _port((x, off, mask, wt, bias), halo=0)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(plain), **TOL)


def test_cpu_wrapper_is_the_plain_version():
    args = list(map(torch.from_numpy, _inputs(scale=3.0)))
    before = dict(dcn.launches)
    for kw in ({}, {"max_offset_y": 2}, {"max_offset": 2}):
        torch.testing.assert_close(dcn.deform_conv2d(*args, **kw),
                                   dcn.deform_conv2d_ref(*args, **kw),
                                   rtol=0, atol=0)
    assert dcn.launches == before   # no kernel launched for CPU tensors
    with pytest.raises(ValueError, match="not both"):
        dcn.deform_conv2d(*args, max_offset_y=2, max_offset=2)


def test_bf16_rounds_fractions_like_jax():
    """In bf16 the plain version rounds fy, fx to the activation type, as
    deform_conv2d does (deform_conv.py:122-123)."""
    args = _inputs(scale=1.5)
    x16 = jnp.asarray(args[0], jnp.bfloat16)
    w16 = jnp.asarray(args[3], jnp.bfloat16)
    b16 = jnp.asarray(args[4], jnp.bfloat16)
    ref = jdc.deform_conv2d(x16, jnp.asarray(args[1]), jnp.asarray(args[2]),
                            w16, b16)
    t = lambda a: torch.tensor(np.asarray(a.astype(jnp.float32)))
    got = dcn.deform_conv2d_ref(t(x16).bfloat16(), torch.from_numpy(args[1]),
                                torch.from_numpy(args[2]), t(w16).bfloat16(),
                                t(b16).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("mode,env", [("off", "0"), ("rowband:2", "rowband:2"),
                                      ("halo:2", "halo:2")])
def test_dcnv2_layer_matches_flax(monkeypatch, mode, env):
    """The layer (offset conv, split, sigmoid, sampling, contraction) with
    conv_offset_mask perturbed so offsets are non-zero and some exceed R.
    In halo mode off the TPU the flax layer clips the offsets and runs the
    XLA path (deform_conv.py:1012): the halo kernel's forward."""
    monkeypatch.setenv("CENTERPOLY_PALLAS_DCN", env)
    rng = np.random.RandomState(4)
    cin, cout = 6, 5
    x = rng.randn(2, 7, 12, cin).astype(np.float32)
    flax_layer = jdc.DCNv2(cout)
    params = {
        "conv_offset_mask": {
            "kernel": (rng.randn(3, 3, cin, 27) * 0.8).astype(np.float32),
            "bias": (rng.randn(27) * 0.5).astype(np.float32)},
        "kernel": (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32),
        "bias": rng.randn(cout).astype(np.float32)}
    ref = flax_layer.apply({"params": params}, jnp.asarray(x))
    om = flax_layer.apply({"params": params}, jnp.asarray(x),
                          mutable=["intermediates"])[1]
    offs = np.asarray(jax.tree_util.tree_leaves(om)[0])
    assert np.abs(offs[..., 0::2]).max() > 2.0   # some y-offsets beyond R

    layer = DCNv2(cin, cout, dcn_kernel=mode)
    with torch.no_grad():
        layer.conv_offset_mask.weight.copy_(torch.from_numpy(np.transpose(
            params["conv_offset_mask"]["kernel"], (3, 2, 0, 1)).copy()))
        layer.conv_offset_mask.bias.copy_(
            torch.from_numpy(params["conv_offset_mask"]["bias"]))
        layer.weight.copy_(torch.from_numpy(
            np.transpose(params["kernel"], (3, 2, 0, 1)).copy()))
        layer.bias.copy_(torch.from_numpy(params["bias"]))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


# (H, W, Cin, Cout) of the 16 DCN nodes of DLA-34 at 512x1024
NODE_SHAPES = [(16, 32, 512, 256), (32, 64, 256, 256), (32, 64, 256, 128),
               (64, 128, 128, 128), (64, 128, 128, 64), (32, 64, 256, 64),
               (128, 256, 64, 64)]
PLAN_CASES = ([(h * w, cin, cout, 132, dt) for h, w, cin, cout in NODE_SHAPES
               for dt in (torch.bfloat16, torch.float32)]
              + [(4 * h * w, cin, cout, 132, torch.float32)
                 for h, w, cin, cout in NODE_SHAPES]
              + [(1, 64, 64, 132, torch.bfloat16),
                 (35, 3, 5, 132, torch.float32),
                 (64, 40, 300, 132, torch.bfloat16),
                 (117, 3, 5, 7, torch.float32),
                 (70, 40, 70, 1, torch.bfloat16),
                 (1, 1, 1, 1000, torch.float32),
                 (0, 64, 64, 132, torch.bfloat16)])


@pytest.mark.parametrize("npix,cin,cout,n_sm,dtype", PLAN_CASES)
def test_fwd_plan_covers_k_once(npix, cin, cout, n_sm, dtype):
    """The splits cut K into contiguous, non-empty ranges that cover every
    (tap, channel chunk) exactly once; never more splits than chunks; one
    split wherever the tiles cover the SMs or there are none (no pixels),
    else tiles x splits covers them (or every chunk is its own split)."""
    plan = dcn.fwd_plan(npix, cin, cout, n_sm, dtype)
    assert plan.ck * dtype.itemsize == dcn.FWD_CHUNK_BYTES
    assert plan.bn >= min(cout, 256) and plan.n_tiles * plan.bn >= cout
    assert plan.m_tiles * dcn.FWD_TILE_PIXELS >= npix
    cpt = -(-cin // plan.ck)
    assert plan.k_chunks == 9 * cpt
    assert 1 <= plan.splits <= plan.k_chunks
    seen = []
    for s in range(plan.splits):
        r = plan.split_chunks(s)
        assert len(r) >= 1 and (not seen or r.start == seen[-1] + 1)
        seen += list(r)
    assert sorted((kc // cpt, kc % cpt) for kc in seen) == [
        (tap, c) for tap in range(9) for c in range(cpt)]
    tiles = plan.m_tiles * plan.n_tiles
    if tiles == 0 or tiles >= n_sm:    # nothing to launch, or a full card
        assert plan.splits == 1
    else:
        assert (tiles * plan.splits >= n_sm
                or plan.splits == plan.k_chunks)


def test_fwd_plan_fills_the_card_on_small_maps():
    """At 132 SMs: the 16x32 and 32x64 nodes split K until tiles x splits
    covers the SMs; the 128x256 node (512 tiles) runs unsplit."""
    for h, w, cin, cout in NODE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            plan = dcn.fwd_plan(h * w, cin, cout, 132, dtype)
            tiles = plan.m_tiles * plan.n_tiles
            assert plan.n_tiles == 1    # all of Cout <= 256 in one block
            if h <= 32:
                assert plan.splits > 1 and tiles * plan.splits >= 132
    assert dcn.fwd_plan(512, 512, 256, 132).splits == 17
    assert dcn.fwd_plan(128 * 256, 64, 64, 132).splits == 1
    assert dcn.fwd_plan(1, 64, 300, 132).n_tiles == 2


def test_lib_path_tracks_every_source_and_header(tmp_path, monkeypatch):
    """The built library's name changes when any .cu or .cuh under csrc/
    changes, so an edited header cannot leave a stale library; other files
    do not count."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(nvcc.CSRC, csrc)
    monkeypatch.setattr(nvcc, "CSRC", str(csrc))
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert headers, "csrc/ holds no header"
    base = {k: nvcc.lib_path(k) for k in nvcc.KERNELS}
    (csrc / "notes.txt").write_text("not a source")
    assert {k: nvcc.lib_path(k) for k in nvcc.KERNELS} == base
    for name in (headers[0], *(f"{k}.cu" for k in nvcc.KERNELS)):
        orig = (csrc / name).read_bytes()
        (csrc / name).write_bytes(orig + b"\n// touched\n")
        for k in nvcc.KERNELS:
            assert nvcc.lib_path(k) != base[k], (name, k)
        (csrc / name).write_bytes(orig)
        assert {k: nvcc.lib_path(k) for k in nvcc.KERNELS} == base


def test_layer_init_and_names():
    block = DeformConvBlock(4, 3)
    names = set(block.state_dict())
    assert {"conv.weight", "conv.bias", "conv.conv_offset_mask.weight",
            "conv.conv_offset_mask.bias", "actf.0.weight",
            "actf.0.running_var"} <= names
    assert torch.all(block.conv.conv_offset_mask.weight == 0)
    assert block.conv.weight.shape == (3, 4, 3, 3)


@pytest.mark.parametrize("mode,r", [("auto", None), ("off", None),
                                    ("on", None), ("0", None),
                                    ("rowband", 4), ("rowband:6", 6),
                                    ("ROWBAND:2", 2), ("halo", 4),
                                    ("halo:4", 4), ("HALO:6", 6),
                                    ("halo:0", 0)])
def test_parse_dcn_kernel(mode, r):
    """-> (clamp mode, R): the mode says which axes R bounds."""
    kind = mode.lower().split(":")[0]
    want = kind if kind in ("rowband", "halo") else "exact"
    assert parse_dcn_kernel(mode) == (want, r)


def test_parse_dcn_kernel_rejects():
    for bad in ("rowband:x", "fused", "on:3", "halo:x", "halo:-1",
                "halo:2.5"):
        with pytest.raises(ValueError):
            parse_dcn_kernel(bad)


def test_dcnv2_clamp_keywords():
    """The layer hands the kernel one clamp keyword by mode."""
    assert DCNv2(4, 3, "off").clamp == {}
    assert DCNv2(4, 3, "rowband:6").clamp == {"max_offset_y": 6}
    assert DCNv2(4, 3, "halo").clamp == {"max_offset": 4}
