"""DCNv2 backward of the PyTorch port against the JAX package.

The port's plain backward (what `deform_conv2d`'s autograd computes on a
CPU tensor: autograd through `deform_conv2d_ref` with the clamp's JAX tie
rule) is held, for all five gradients, against
  * exact mode: jax.vjp of centerpoly_tpu.models.deform_conv.deform_conv2d
    (the backward the JAX package trains with, deform_conv.py:744-749);
  * rowband:R: jax.vjp of the row-band Pallas kernel in interpret mode,
    whose backward is the fused Pallas kernel (dcn_rowband.py:190);
  * halo:R: jax.vjp of the halo Pallas kernel in interpret mode, whose
    backward is the three sample sweeps and the dx sweep (dcn_halo.py:173,
    231) with the XLA einsums around them.
Tolerance rtol 1e-4, atol 1e-5 in f32, that of tests/test_dcn_rowband.py
and tests/test_dcn_halo.py.

The halo tie rule: the port zeroes each offset gradient where |o| >= R,
the exact bound included, as the halo kernel's backward does
(dcn_halo.py:442-450), on the card and on the CPU alike.  The JAX oracle
deform_conv2d_halo_ref and the JAX module's XLA fallback (what runs off
the TPU) pass 0.5 of the one-sided derivative at exactly +-R (jnp.clip's
tie rule); `test_halo_gradient_is_zero_at_and_beyond_r` shows both.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.kernels.dcn_halo import (deform_conv2d_halo,
                                             deform_conv2d_halo_ref)
from centerpoly_tpu.kernels.dcn_rowband import deform_conv2d_rowband
from centerpoly_tpu.models import deform_conv as jdc
from centerpoly_tpu_torch.kernels import dcn
from centerpoly_tpu_torch.models.deform_conv import DCNv2

TOL = dict(rtol=1e-4, atol=1e-5)
R = 2
NAMES = ("dx", "doffsets", "dmasks", "dweights", "dbias")


def _inputs(b=2, h=6, w=10, c=8, cout=5, seed=0, scale=1.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = (rng.randn(b, h, w, 18) * scale).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(b, h, w, 9)))).astype(np.float32)
    wt = (rng.randn(3, 3, c, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    g = rng.randn(b, h, w, cout).astype(np.float32)
    return [x, off, mask, wt, bias], g


def _at_r(off):
    off = off.copy()
    off[..., 0::2] = np.where(off[..., 0::2] > 0, R, -R)
    return off


def _edges(off):
    """Half the y- and x-offsets push samples 12 px off the image."""
    off = off.copy()
    off[..., ::3] = 12.0 * np.sign(off[..., ::3])
    return off


CASES = {"random": lambda o: o, "zero": np.zeros_like, "at_r": _at_r,
         "beyond_r": lambda o: o * 3, "edges": _edges}


def _port_grads(args, g, r, halo=None):
    """Gradients through the port's `deform_conv2d` (its autograd.Function
    on a CPU tensor), rowband:r or halo:halo."""
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = dcn.deform_conv2d(*leaves, max_offset_y=r, max_offset=halo)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in leaves]


def _jax_grads(fn, args, g):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _assert_grads(got, ref):
    for name, a, b in zip(NAMES, got, ref):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_backward_matches_jax(case):
    args, g = _inputs()
    args[1] = CASES[case](args[1])
    _assert_grads(_port_grads(args, g, None),
                  _jax_grads(jdc.deform_conv2d, args, g))


@pytest.mark.parametrize("case", sorted(CASES))
def test_rowband_backward_matches_pallas_interpret(case):
    args, g = _inputs(h=5, w=8)
    args[1] = CASES[case](args[1])
    ref = _jax_grads(lambda *a: deform_conv2d_rowband(*a, R, True), args, g)
    _assert_grads(_port_grads(args, g, R), ref)


def test_backward_ref_is_what_autograd_gives():
    """The CPU wrapper's backward is `deform_conv2d_backward_ref` and
    launches no kernel."""
    args, g = _inputs(scale=3.0)
    before = dict(dcn.launches)
    for r, halo in ((None, None), (R, None), (None, R)):
        ref = dcn.deform_conv2d_backward_ref(
            *map(torch.from_numpy, args), torch.from_numpy(g), r, halo)
        got = dcn.deform_conv2d_backward(
            *map(torch.from_numpy, args), torch.from_numpy(g), r, halo)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        _assert_grads(_port_grads(args, g, r, halo),
                      [t.numpy() for t in ref])
    assert dcn.launches == before


def _ramp_case(oy):
    """One channel whose value is the row index, only the centre tap
    weighted: out = the sample at (y + oy, x), so d out / d oy is the
    row difference the sample straddles."""
    h, w = 5, 4
    x = np.broadcast_to(np.arange(h, dtype=np.float32)[None, :, None, None],
                        (1, h, w, 1)).copy()
    off = np.zeros((1, h, w, 18), np.float32)
    off[..., 8] = oy                   # tap 4 (centre), y component
    mask = np.ones((1, h, w, 9), np.float32)
    wt = np.zeros((3, 3, 1, 1), np.float32)
    wt[1, 1] = 1.0
    return [x, off, mask, wt, np.zeros(1, np.float32)], np.ones(
        (1, h, w, 1), np.float32)


def test_integer_position_takes_the_floor_cell_derivative():
    """At an integer position the y derivative is that of the floor cell
    (hat derivative -1 there): x[y+1] - x[y] = 1, and at the last row the
    missing row below reads 0: -(H-1).  A symmetric rule would give 0.5."""
    args, g = _ramp_case(0.0)
    for r in (None, R):
        doy = _port_grads(args, g, r)[1][0, :, :, 8]
        np.testing.assert_array_equal(doy[:-1], 1.0)
        np.testing.assert_array_equal(doy[-1], -4.0)


def test_gradient_halves_exactly_at_r():
    """y-offset exactly R: the rowband gradient is 0.5 of the exact one;
    beyond R it is 0; the x-offsets pass unchanged."""
    for oy, factor in ((float(R), 0.5), (-float(R), 0.5), (R + 0.5, 0.0)):
        args, g = _ramp_case(oy)
        exact = _port_grads([args[0], _clip_y(args[1]), *args[2:]], g, None)
        band = _port_grads(args, g, R)
        np.testing.assert_allclose(band[1][..., 0::2],
                                   factor * exact[1][..., 0::2], rtol=1e-6)
        np.testing.assert_allclose(band[1][..., 1::2], exact[1][..., 1::2],
                                   rtol=1e-6)
        np.testing.assert_allclose(band[0], exact[0], rtol=1e-6)


def _interior_integer(off):
    """Integer offsets strictly inside (-R, R): every sample on a pixel,
    where the one-sided floor-cell derivative is taken."""
    return np.clip(np.round(off), -(R - 1), R - 1)


HALO_CASES = {"random": lambda o: o, "zero": np.zeros_like,
              "integer": _interior_integer}


@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_halo_backward_matches_pallas_interpret(case):
    """All five gradients against jax.vjp of the halo kernel (interpret);
    `random` (offsets x1.5) has offsets beyond R on both axes."""
    args, g = _inputs(b=1, h=6, w=8)
    args[1] = HALO_CASES[case](args[1])
    ref = _jax_grads(lambda *a: deform_conv2d_halo(*a, R, True), args, g)
    _assert_grads(_port_grads(args, g, None, halo=R), ref)


def _ramp(o, axis):
    """One channel whose value is the coordinate along `axis` (0 = y,
    1 = x), only the centre tap weighted, its offset `o` along that axis:
    out = the sample at the shifted position, so d out / d o is the
    difference of the two pixels it straddles."""
    h, w = 6, 6
    coord = np.arange(h if axis == 0 else w, dtype=np.float32)
    x = (coord[None, :, None, None] if axis == 0
         else coord[None, None, :, None]) * np.ones((1, h, w, 1), np.float32)
    off = np.zeros((1, h, w, 18), np.float32)
    off[..., 8 + axis] = o             # tap 4 (centre)
    mask = np.ones((1, h, w, 9), np.float32)
    wt = np.zeros((3, 3, 1, 1), np.float32)
    wt[1, 1] = 1.0
    return [x, off, mask, wt, np.zeros(1, np.float32)], np.ones(
        (1, h, w, 1), np.float32)


@pytest.mark.parametrize("axis", [0, 1])
def test_halo_gradient_is_zero_at_and_beyond_r(axis):
    """An offset exactly at +-R or beyond it gets gradient 0 on either
    axis (the other component, inside the band, keeps its own): the halo
    kernel's rule (dcn_halo.py:442-450), which the port
    follows.  The oracle deform_conv2d_halo_ref (and the JAX module's XLA
    fallback) gives 0.5 of the one-sided derivative at exactly +-R, 0
    beyond; the kernel cannot give that half, because the floor+1 cell of
    an extreme tap at the bound lies outside its swept band."""
    for o in (float(R), -float(R), R + 0.5, -R - 0.5):
        args, g = _ramp(o, axis)
        doff = _port_grads(args, g, None, halo=R)[1]
        np.testing.assert_array_equal(doff[..., 8 + axis], 0.0)
        oracle = _jax_grads(lambda *a: deform_conv2d_halo_ref(*a, R),
                            args, g)[1]
        inside = slice(R + 1, -R - 1)      # samples that stay in the image
        if abs(o) == R:
            # jnp.clip's tie: half the floor-cell difference of the ramp (1)
            rows = (oracle[0, inside, :, 8 + axis] if axis == 0
                    else oracle[0, :, inside, 8 + axis])
            np.testing.assert_allclose(rows, 0.5)
        else:
            np.testing.assert_array_equal(oracle[..., 8 + axis], 0.0)
    # and the Pallas kernel itself gives 0 at the bound
    args, g = _ramp(float(R), axis)
    kernel = _jax_grads(lambda *a: deform_conv2d_halo(*a, R, True), args, g)
    np.testing.assert_array_equal(kernel[1][..., 8 + axis], 0.0)


def test_halo_zero_passes_no_offset_gradient():
    """halo:0 clamps every offset to 0, so every offset sits on the bound:
    all offset gradients are 0, and the other four are those of the
    modulated plain conv (exact mode at zero offsets)."""
    args, g = _inputs(scale=3.0)
    got = _port_grads(args, g, None, halo=0)
    np.testing.assert_array_equal(got[1], 0.0)
    plain = _port_grads([args[0], np.zeros_like(args[1]), *args[2:]], g, None)
    for name, a, b in zip(NAMES, got, plain):
        if name != "doffsets":
            np.testing.assert_allclose(a, b, **TOL, err_msg=name)


def test_clamp_xy_forward_and_keep():
    o = torch.tensor([-3.0, -2.0, -1.0, 0.0, 2.0, 2.5])
    off = torch.stack([o, o.flip(0)], -1).reshape(1, 12).requires_grad_(True)
    out = dcn.clamp_xy(off, 2.0)
    np.testing.assert_array_equal(out[0, 0::2].detach().numpy(),
                                  [-2, -2, -1, 0, 2, 2])
    np.testing.assert_array_equal(out[0, 1::2].detach().numpy(),
                                  [2, 2, 0, -1, -2, -2])
    out.sum().backward()
    np.testing.assert_array_equal(off.grad[0, 0::2].numpy(),
                                  [0, 0, 1, 1, 0, 0])
    np.testing.assert_array_equal(off.grad[0, 1::2].numpy(),
                                  [0, 0, 1, 1, 0, 0])


def _clip_y(off):
    off = off.copy()
    off[..., 0::2] = np.clip(off[..., 0::2], -R, R)
    return off


def test_clamp_y_forward_and_keep():
    oy = torch.tensor([-3.0, -2.0, -1.0, 0.0, 2.0, 2.5])
    off = torch.stack([oy, oy], -1).reshape(1, 12).requires_grad_(True)
    out = dcn.clamp_y(off, 2.0)
    np.testing.assert_array_equal(out[0, 0::2].detach().numpy(),
                                  [-2, -2, -1, 0, 2, 2])
    out.sum().backward()
    np.testing.assert_array_equal(off.grad[0, 0::2].numpy(),
                                  [0, 0.5, 1, 1, 0.5, 0])
    np.testing.assert_array_equal(off.grad[0, 1::2].numpy(), np.ones(6))


@pytest.mark.parametrize("mode,env", [("off", "0"), ("rowband:2", "rowband:2"),
                                      ("halo:2", "halo:2")])
def test_dcnv2_layer_grads_match_flax(monkeypatch, mode, env):
    """The layer's gradients (offset conv, main weight and bias, input)
    against flax's, with conv_offset_mask perturbed so offsets are
    non-zero and some exceed R.  (In halo mode off the TPU flax runs its
    clipped XLA path; random offsets land on exactly +-R with probability
    0, where its tie rule differs.)"""
    monkeypatch.setenv("CENTERPOLY_PALLAS_DCN", env)
    rng = np.random.RandomState(4)
    cin, cout = 6, 5
    x = rng.randn(2, 7, 12, cin).astype(np.float32)
    g = rng.randn(2, 7, 12, cout).astype(np.float32)
    params = {
        "conv_offset_mask": {
            "kernel": (rng.randn(3, 3, cin, 27) * 0.8).astype(np.float32),
            "bias": (rng.randn(27) * 0.5).astype(np.float32)},
        "kernel": (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32),
        "bias": rng.randn(cout).astype(np.float32)}
    flax_layer = jdc.DCNv2(cout)

    def jloss(p, a):
        return jnp.sum(flax_layer.apply({"params": p}, a) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    layer = DCNv2(cin, cout, dcn_kernel=mode)
    with torch.no_grad():
        layer.conv_offset_mask.weight.copy_(torch.from_numpy(np.transpose(
            params["conv_offset_mask"]["kernel"], (3, 2, 0, 1)).copy()))
        layer.conv_offset_mask.bias.copy_(
            torch.from_numpy(params["conv_offset_mask"]["bias"]))
        layer.weight.copy_(torch.from_numpy(
            np.transpose(params["kernel"], (3, 2, 0, 1)).copy()))
        layer.bias.copy_(torch.from_numpy(params["bias"]))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    (layer(tx).permute(0, 2, 3, 1) * torch.from_numpy(g)).sum().backward()

    hwio = lambda t: np.transpose(t.grad.numpy(), (2, 3, 1, 0))  # noqa: E731
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jgx), **TOL)
    np.testing.assert_allclose(hwio(layer.weight), np.asarray(jgp["kernel"]),
                               **TOL)
    np.testing.assert_allclose(layer.bias.grad.numpy(),
                               np.asarray(jgp["bias"]), **TOL)
    np.testing.assert_allclose(hwio(layer.conv_offset_mask.weight),
                               np.asarray(jgp["conv_offset_mask"]["kernel"]),
                               **TOL)
    np.testing.assert_allclose(layer.conv_offset_mask.bias.grad.numpy(),
                               np.asarray(jgp["conv_offset_mask"]["bias"]),
                               **TOL)


# (H, W, Cin, Cout) of the 16 DLA-34 DCN nodes at 512x1024 input
NODE_SHAPES = [(16, 32, 512, 256), (32, 64, 256, 256), (32, 64, 256, 128),
               (64, 128, 128, 128), (64, 128, 128, 64), (32, 64, 256, 64),
               (128, 256, 64, 64)]
BWD_PLAN_CASES = ([(b * h * w, cin, cout, 132) for h, w, cin, cout
                   in NODE_SHAPES for b in (4, 1)]
                  + [(1, 64, 64, 132), (35, 3, 5, 132), (64, 40, 300, 132),
                     (117, 3, 5, 7), (2 * 64 * 128, 128, 64, 132),
                     (70, 40, 70, 1), (0, 64, 64, 132)])


@pytest.mark.parametrize("npix,cin,cout,n_sm", BWD_PLAN_CASES)
def test_bwd_plan_covers_every_pixel_and_tap_once(npix, cin, cout, n_sm):
    """dW's splits cut the pixel tiles into contiguous, non-empty ranges in
    order that hold every pixel exactly once; never more splits than
    64-pixel tiles; one split where the (tap, chunk, channel) tiles fill
    the card (BWD_WAVES blocks an SM), else tiles x splits does (or every
    pixel tile is its own split), so it always covers the SMs.
    dcn_bwd_data's tap ranges hold each tap once."""
    plan = dcn.bwd_plan(npix, cin, cout, n_sm)
    assert plan.k_tiles == 9 * -(-cin // dcn.BWD_WEIGHT_CHANNELS)
    assert plan.n_tiles * plan.bn >= cout and plan.bn >= min(cout, 256)
    assert plan.m_tiles * dcn.FWD_TILE_PIXELS >= npix
    assert 1 <= plan.splits <= max(plan.m_tiles, 1)
    pixels = []
    for s in range(plan.splits):
        r = plan.split_tiles(s)
        assert npix == 0 or len(r) >= 1
        for tile in r:
            pixels += range(tile * dcn.FWD_TILE_PIXELS,
                            min((tile + 1) * dcn.FWD_TILE_PIXELS, npix))
    assert pixels == list(range(npix))
    tiles = plan.k_tiles * plan.n_tiles
    full = dcn.BWD_WAVES * n_sm
    if npix == 0 or tiles >= full:
        assert plan.splits == 1
    else:
        assert (tiles * plan.splits >= full
                or plan.splits == plan.m_tiles)
    assert npix == 0 or tiles * plan.splits >= min(n_sm, tiles * plan.m_tiles)
    assert 1 <= plan.data_splits <= 9
    taps = [k for s in range(plan.data_splits) for k in plan.data_taps(s)]
    assert taps == list(range(9))
    assert all(len(plan.data_taps(s)) >= 1 for s in range(plan.data_splits))


def test_bwd_plan_fills_the_card_at_the_node_shapes():
    """A train step's nodes (f32, batch 4) at 132 SMs: dW's tiles x splits
    fill the card BWD_WAVES times and dcn_bwd_data's pixel tiles x tap
    ranges cover it (as far as 9 tap ranges go); the 16x32 512->256
    node's 72 dW tiles take 8 pixel ranges, the 128x256 node's 9 take 59;
    one split where the tiles alone fill the card."""
    for h, w, cin, cout in NODE_SHAPES:
        plan = dcn.bwd_plan(4 * h * w, cin, cout, 132)
        assert (plan.k_tiles * plan.n_tiles * plan.splits
                >= dcn.BWD_WAVES * 132)
        assert (plan.m_tiles * plan.data_splits >= dcn.BWD_WAVES * 132
                or plan.data_splits == 9)
    assert dcn.bwd_plan(4 * 16 * 32, 512, 256, 132).splits == 8
    assert dcn.bwd_plan(4 * 16 * 32, 512, 256, 132).data_splits == 9
    assert dcn.bwd_plan(4 * 128 * 256, 64, 64, 132).data_splits == 1
    assert dcn.bwd_plan(4 * 128 * 256, 64, 64, 132).splits == 59
    assert dcn.bwd_plan(4 * 128 * 256, 1024, 1024, 132).splits == 1
    assert dcn.bwd_plan(64, 40, 300, 132).n_tiles == 2
