"""Training losses and polygon geometry of the PyTorch port against the JAX
package: every loss value and every input gradient, on one shared batch
made with numpy from a seed.

Tolerances (f32, CPU): values rtol 1e-5; gradients rtol 1e-4 / atol 1e-6
(the same arithmetic, summed in another order).  The non-smooth points are
held to jax.grad exactly: clip ties (0.5), abs at 0, the argsort of
poly_iou_loss and the half-weight rule of coincident polygon edges.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.geometry import polygon as jpoly
from centerpoly_tpu.losses import focal as jfocal
from centerpoly_tpu.losses import poly as jpl
from centerpoly_tpu.losses import polydet as jpd
from centerpoly_tpu.losses import regression as jreg
from centerpoly_tpu_torch.geometry import polygon as tpoly
from centerpoly_tpu_torch.losses import focal as tfocal
from centerpoly_tpu_torch.losses import poly as tpl
from centerpoly_tpu_torch.losses import polydet as tpd
from centerpoly_tpu_torch.losses import regression as treg

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
B, K, N, H, W, C = 2, 6, 16, 12, 20, 3


def _value_and_grads(jfn, tfn, args, argnums=(0,)):
    """(jax value, jax grads, torch value, torch grads) of fn(*args) for
    the float arrays at `argnums`."""
    jv, jg = jax.value_and_grad(jfn, argnums=argnums)(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=i in argnums)
             for i, a in enumerate(args)]
    tv = tfn(*targs)
    tg = torch.autograd.grad(tv, [targs[i] for i in argnums])
    return np.asarray(jv), [np.asarray(g) for g in jg], tv.detach().numpy(), \
        [g.numpy() for g in tg]


def _check(jfn, tfn, args, argnums=(0,)):
    jv, jg, tv, tg = _value_and_grads(jfn, tfn, args, argnums)
    np.testing.assert_allclose(tv, jv, **VAL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **GRAD)


def _polar_polys(rng, shape, n=N, rmin=1.0, rmax=8.0):
    th = np.sort(rng.uniform(0, 2 * np.pi, (*shape, n)), axis=-1)
    r = rng.uniform(rmin, rmax, (*shape, n))
    return np.stack([r, th], -1).astype(np.float32)


def _batch(seed=0, rep="polar"):
    """GT batch and NHWC head maps for B images of K object slots."""
    rng = np.random.RandomState(seed)
    hm = (rng.rand(B, H, W, C) ** 3).astype(np.float32)
    ind = rng.randint(0, H * W, (B, K)).astype(np.int64)
    for b in range(B):
        for k in range(3):
            hm.reshape(B, H * W, C)[b, ind[b, k], k % C] = 1.0
    mask = (rng.rand(B, K) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    if rep == "cartesian":
        poly = rng.randn(B, K, 2 * N).astype(np.float32) * 5
    else:
        poly = _polar_polys(rng, (B, K)).reshape(B, K, 2 * N)
    out = {"hm": rng.randn(B, H, W, C).astype(np.float32),
           "poly": poly_map(rng, poly, ind),
           "pseudo_depth": rng.randn(B, H, W, 1).astype(np.float32),
           "reg": rng.rand(B, H, W, 2).astype(np.float32)}
    gt = {"hm": hm, "ind": ind, "reg_mask": mask, "poly": poly,
          "pseudo_depth": rng.rand(B, K, 1).astype(np.float32) * 3,
          "reg": rng.rand(B, K, 2).astype(np.float32)}
    return out, gt


def poly_map(rng, poly, ind):
    """A poly head map whose values at the object peaks lie near the GT
    (angles perturbed a little, so the argsort sees a few swaps)."""
    m = rng.randn(B, H * W, 2 * N).astype(np.float32)
    for b in range(B):
        m[b, ind[b]] = poly[b] + 0.3 * rng.randn(K, 2 * N)
    return m.reshape(B, H, W, 2 * N)


# -- focal / regression ------------------------------------------------------

@pytest.mark.parametrize("positives", [True, False])
def test_focal_loss(positives):
    out, gt = _batch()
    hm = gt["hm"] if positives else np.minimum(gt["hm"], 0.9)
    _check(lambda x, g: jfocal.focal_loss(jfocal.clamped_sigmoid(x), g),
           lambda x, g: tfocal.focal_loss(tfocal.clamped_sigmoid(x), g),
           (out["hm"], hm))


def test_clamped_sigmoid_tie_gradient():
    """At exactly the clip bound the gradient halves, as jnp.clip's."""
    x = np.array([0.0, 30.0, -30.0], np.float32)
    _check(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0)),
           lambda a: tpoly.clip(a, 0.0, 1.0).sum(), (x,))
    _check(lambda a: jnp.sum(jfocal.clamped_sigmoid(a)),
           lambda a: tfocal.clamped_sigmoid(a).sum(), (x,))


def test_reg_l1_loss():
    out, gt = _batch()
    _check(lambda o, t: jreg.reg_l1_loss(o, jnp.asarray(gt["reg_mask"]),
                                         jnp.asarray(gt["ind"]), t),
           lambda o, t: treg.reg_l1_loss(o, torch.tensor(gt["reg_mask"]),
                                         torch.tensor(gt["ind"]), t),
           (out["reg"], gt["reg"]), argnums=(0, 1))


def test_reg_l1_abs_at_zero():
    """Prediction equal to the target: abs at 0 passes gradient 0."""
    out, gt = _batch()
    o = out["reg"].reshape(B, H * W, 2)
    for b in range(B):
        o[b, gt["ind"][b]] = gt["reg"][b]
    _check(lambda x: jreg.reg_l1_loss(x, jnp.asarray(gt["reg_mask"]),
                                      jnp.asarray(gt["ind"]),
                                      jnp.asarray(gt["reg"])),
           lambda x: treg.reg_l1_loss(x, torch.tensor(gt["reg_mask"]),
                                      torch.tensor(gt["ind"]),
                                      torch.tensor(gt["reg"])),
           (o.reshape(B, H, W, 2),))


# -- geometry ----------------------------------------------------------------

def _xy(rt):
    return np.stack([rt[..., 0] * np.cos(rt[..., 1]),
                     rt[..., 0] * np.sin(rt[..., 1])], -1).astype(np.float32)


def test_polar_to_cartesian_and_area():
    rt = _polar_polys(np.random.RandomState(1), (4,))
    np.testing.assert_allclose(
        tpoly.polar_to_cartesian(torch.tensor(rt)).numpy(),
        np.asarray(jpoly.polar_to_cartesian(jnp.asarray(rt))), **VAL)
    _check(lambda p: jnp.sum(jpoly.polygon_area(p)),
           lambda p: tpoly.polygon_area(p).sum(), (_xy(rt),))


@pytest.mark.parametrize("family", ["random", "shared_spokes"])
def test_intersection_area_matches_jax(family):
    rng = np.random.RandomState(2)
    p = _polar_polys(rng, (8,), rmax=30.0)
    q = _polar_polys(rng, (8,), rmax=30.0)
    if family == "shared_spokes":   # polar_fixed: the same fixed angles
        th = np.arange(N) * 2 * np.pi / N
        p[..., 1] = th
        q[..., 1] = th
    _check(lambda a, b: jnp.sum(jax.vmap(jpoly.polygon_intersection_area)(
        a, b)), lambda a, b: tpoly.polygon_intersection_area(a, b).sum(),
           (_xy(p), _xy(q)), argnums=(0, 1))
    _check(lambda a, b: jnp.sum(jax.vmap(jpoly.polygon_iou)(a, b)),
           lambda a, b: tpoly.polygon_iou(a, b).sum(),
           (_xy(p), _xy(q)), argnums=(0, 1))


@pytest.mark.parametrize("case", ["identical", "collinear", "random"])
def test_closed_form_matches_scan_oracles(case):
    """The closed form against the port's scan oracle and the JAX
    package's: identical polygons (every edge coincident, counted once by
    the half-weight rule), two squares sharing an edge (collinear, area
    0) and a random polar pair."""
    rng = np.random.RandomState(3)
    if case == "identical":
        p = q = _xy(_polar_polys(rng, ()))
    elif case == "collinear":
        p = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32) + 1
        q = p + np.array([4, 0], np.float32)
    else:
        p, q = _xy(_polar_polys(rng, ())), _xy(_polar_polys(rng, ()))
    fast = tpoly.polygon_intersection_area(torch.tensor(p), torch.tensor(q))
    scan = tpoly.polygon_intersection_area_scan(torch.tensor(p),
                                                torch.tensor(q))
    jscan = jpoly.polygon_intersection_area_scan(jnp.asarray(p),
                                                 jnp.asarray(q))
    np.testing.assert_allclose(float(scan), float(jscan), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(float(fast), float(scan), rtol=1e-3,
                               atol=1e-3)
    if case == "identical":
        np.testing.assert_allclose(float(fast), float(tpoly.polygon_area(
            torch.tensor(p))), rtol=0.02)
        assert abs(float(tpoly.polygon_iou(torch.tensor(p),
                                           torch.tensor(q))) - 1) < 0.02
    if case == "collinear":
        assert abs(float(fast)) < 1e-3
    # and the gradient of the closed form at these degenerate pairs
    _check(lambda a, b: jpoly.polygon_iou(a, b),
           lambda a, b: tpoly.polygon_iou(a, b), (p, q), argnums=(0, 1))


# -- polygon losses ----------------------------------------------------------

def test_order_loss():
    out, gt = _batch()
    pred = gt["poly"] + np.random.RandomState(4).randn(
        *gt["poly"].shape).astype(np.float32)
    pred[0, 0, 1::2] = np.linspace(3, 7, N)       # wraps past 2 pi
    pred[0, 1, 3] = pred[0, 1, 5]                 # a tie: max(0, 0)
    m = jnp.asarray(gt["reg_mask"])
    _check(lambda p: jpl.order_loss(p, m),
           lambda p: tpl.order_loss(p, torch.tensor(gt["reg_mask"])), (pred,))


def test_poly_iou_loss():
    out, gt = _batch()
    pred = gt["poly"] + 0.4 * np.random.RandomState(5).randn(
        *gt["poly"].shape).astype(np.float32)
    pred[0, 1] = gt["poly"][0, 1]                 # identical polygon
    pred[1, 0, 0::2] *= -1                        # negative radii: abs
    m = gt["reg_mask"]
    _check(lambda p, t: jpl.poly_iou_loss(p, t, jnp.asarray(m)),
           lambda p, t: tpl.poly_iou_loss(p, t, torch.tensor(m)),
           (pred, gt["poly"]), argnums=(0, 1))


@pytest.mark.parametrize("rep,deadzone", [("cartesian", None),
                                          ("cartesian", 20.0),
                                          ("polar", None),
                                          ("polar_fixed", None)])
def test_poly_l1_loss(rep, deadzone):
    out, gt = _batch(rep=rep)
    pred = gt["poly"] + 30 * np.random.RandomState(6).randn(
        *gt["poly"].shape).astype(np.float32) * (deadzone is not None)
    pred = pred + 0.5 * np.random.RandomState(7).randn(*pred.shape)
    m = gt["reg_mask"]
    _check(lambda p: jpl.poly_l1_loss(p, jnp.asarray(gt["poly"]),
                                      jnp.asarray(m), rep, deadzone),
           lambda p: tpl.poly_l1_loss(p, torch.tensor(gt["poly"]),
                                      torch.tensor(m), rep, deadzone),
           (pred.astype(np.float32),))


@pytest.mark.parametrize("kind,rep,order", [("l1+iou", "polar", True),
                                            ("iou", "polar_fixed", False),
                                            ("relu", "cartesian", False),
                                            ("l1", "cartesian", True)])
def test_polydet_loss(kind, rep, order):
    """The whole loss and its gradient with respect to every head map."""
    out, gt = _batch(rep=rep)
    jcfg = jpd.PolydetLossConfig(rep=rep, poly_loss=kind, poly_order=order)
    tcfg = tpd.PolydetLossConfig(rep=rep, poly_loss=kind, poly_order=order)
    names = sorted(out)

    def jfn(*maps):
        loss, stats = jpd.polydet_loss([dict(zip(names, maps))],
                                       jax.tree.map(jnp.asarray, gt), jcfg)
        return loss, stats

    (jv, jstats), jg = jax.value_and_grad(jfn, argnums=tuple(range(4)),
                                          has_aux=True)(
        *[jnp.asarray(out[n]) for n in names])
    maps = [torch.tensor(out[n], requires_grad=True) for n in names]
    tv, tstats = tpd.polydet_loss([dict(zip(names, maps))],
                                  {k: torch.tensor(v) for k, v in gt.items()},
                                  tcfg)
    tg = torch.autograd.grad(tv, maps)
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), **VAL)
    for n, a, b in zip(names, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=n)
