"""DCNv2 backward of the PyTorch port against the JAX package.

The port's plain backward (what `deform_conv2d`'s autograd computes on a
CPU tensor: autograd through `deform_conv2d_ref` with the clamp's JAX tie
rule) is held, for all five gradients, against
  * exact mode: jax.vjp of centerpoly_tpu.models.deform_conv.deform_conv2d
    (the backward the JAX package trains with, deform_conv.py:744-749);
  * rowband:R: jax.vjp of the row-band Pallas kernel in interpret mode,
    whose backward is the fused Pallas kernel (dcn_rowband.py:190).
Tolerance rtol 1e-4, atol 1e-5 in f32, that of tests/test_dcn_rowband.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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


def _port_grads(args, g, r):
    """Gradients through the port's `deform_conv2d` (its autograd.Function
    on a CPU tensor)."""
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = dcn.deform_conv2d(*leaves, max_offset_y=r)
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
    for r in (None, R):
        ref = dcn.deform_conv2d_backward_ref(
            *map(torch.from_numpy, args), torch.from_numpy(g), r)
        got = dcn.deform_conv2d_backward(
            *map(torch.from_numpy, args), torch.from_numpy(g), r)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        _assert_grads(_port_grads(args, g, r), [t.numpy() for t in ref])
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


@pytest.mark.parametrize("mode,env", [("off", "0"), ("rowband:2", "rowband:2")])
def test_dcnv2_layer_grads_match_flax(monkeypatch, mode, env):
    """The layer's gradients (offset conv, main weight and bias, input)
    against flax's, with conv_offset_mask perturbed so offsets are
    non-zero and some exceed R."""
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
