"""The experimental raster losses of the PyTorch port (losses/
experimental.py) and the numpy Pillow fill under them (geometry/
pil_fill.py), against Pillow and the JAX package's (CPU).

* `pil_fill.polygon` / `pil_fill.ellipse` write Pillow's pixels on 400
  seeded cases: float, negative and off-canvas coordinates, convex,
  star-shaped, self-crossing and degenerate polygons (random walks,
  repeated and collinear vertices, two points), thin and empty
  ellipses, with `outline` 255, 0 and None;
* the host half (`create_mask`, `disk_loss`, `area_poly_loss`) bit-equal
  to the JAX package's, which draws with Pillow, in every rep, on the
  cases of tests/test_experimental_losses.py and on random rows;
* the device half (`_rep_to_xy`, `soft_polygon_mask`, `soft_disks_mask`,
  `disk_loss_device`, `area_poly_loss_device`) at 64x96: masks and losses
  within 1e-5 of JAX's, the gradients of `pred` (torch autograd against
  `jax.grad`) within 1e-4.
"""
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (caps torch's threads)

from PIL import Image, ImageDraw  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from centerpoly_tpu.losses import experimental as jexp  # noqa: E402
from centerpoly_tpu_torch.geometry import pil_fill  # noqa: E402
from centerpoly_tpu_torch.losses import experimental as texp  # noqa: E402

REPS = ("cartesian", "polar", "polar_fixed")
H, W = 64, 96


# -- the fill against Pillow -------------------------------------------------

def _polygon_points(kind, rng, h, w):
    n = int(rng.randint(2, 30))
    if kind == "float_wide":            # far off the canvas on every side
        return rng.uniform(-100, 2.5 * max(h, w), (n, 2))
    if kind == "integer":
        return rng.randint(-5, max(h, w) + 5, (n, 2)).astype(float)
    if kind == "star":                  # a star-shaped polygon, like a head's
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(0, 0.8 * max(h, w), n)
        c = np.array([w / 2, h / 2]) + rng.uniform(-20, 20, 2)
        return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
    if kind == "grid":                  # repeated and collinear vertices
        return np.round(rng.uniform(-3, max(h, w), (n, 2)) / 8) * 8
    if kind == "walk":                  # a random walk: spikes and retraces
        return (np.cumsum(rng.randint(-3, 4, (n, 2)), 0).astype(float)
                + rng.uniform(0, 0.8 * min(h, w), 2))
    if kind == "near_integer":          # truncation toward zero matters
        return rng.uniform(-1.5, 1.5, (n, 2)) + rng.randint(-2, 60, (n, 2))
    return rng.uniform(-5000, 5000, (n, 2))        # "huge"


POLY_KINDS = ("float_wide", "integer", "star", "grid", "walk",
              "near_integer", "huge")


@pytest.mark.parametrize("kind", POLY_KINDS)
def test_polygon_fill_is_pillows(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    for case in range(40):
        h, w = (int(v) for v in rng.randint(1, 100, 2))
        pts = _polygon_points(kind, rng, h, w)
        for fill, outline in ((255, 255), (255, 0), (255, None),
                              (None, 255), (None, 0)):
            bg = 128 if outline == 0 else 0
            im = Image.new("L", (w, h), bg)
            ImageDraw.Draw(im).polygon([tuple(p) for p in pts], fill=fill,
                                       outline=outline)
            got = pil_fill.polygon(np.full((h, w), bg, np.uint8), pts,
                                   fill=fill, outline=outline)
            np.testing.assert_array_equal(
                got, np.asarray(im), err_msg=f"{kind} {case} {fill} "
                f"{outline} {pts.tolist()}")


@pytest.mark.parametrize("kind", ["float", "integer", "thin"])
def test_ellipse_is_pillows(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    for case in range(40):
        h, w = (int(v) for v in rng.randint(1, 100, 2))
        x0, y0 = rng.uniform(-30, 110, 2)
        if kind == "float":
            a, b = rng.uniform(0, 80, 2)
        elif kind == "integer":
            x0, y0 = np.round([x0, y0])
            a, b = rng.randint(0, 40, 2).astype(float)
        else:
            a, b = rng.uniform(0, 3, 2)
            if case % 2:
                a = rng.uniform(0, 60)
        box = [(x0, y0), (x0 + a, y0 + b)]
        for fill, outline in ((255, 255), (255, 0), (None, 255),
                              (255, None)):
            im = Image.new("L", (w, h), 0)
            ImageDraw.Draw(im).ellipse(box, fill=fill, outline=outline)
            got = pil_fill.ellipse(np.zeros((h, w), np.uint8), box,
                                   fill=fill, outline=outline)
            np.testing.assert_array_equal(
                got, np.asarray(im), err_msg=f"{kind} {case} {box}")


def test_fill_refuses_what_pillow_refuses():
    with pytest.raises(TypeError, match="at least 2"):
        pil_fill.polygon(np.zeros((4, 4), np.uint8), [(1.0, 1.0)], 255)
    with pytest.raises(ValueError, match="x1"):
        pil_fill.ellipse(np.zeros((4, 4), np.uint8), [(3, 3), (2, 4)], 255)


# -- the host half against JAX's ---------------------------------------------

def _octagon(r=10.0, n=8):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], -1).reshape(-1)


def _rows(rng, rep, b, k, n, radius=False):
    """(b, k, 2n [+1]) rows of a head in `rep`: cartesian offsets, or
    (r, theta) with increasing angles."""
    if rep == "cartesian":
        rows = rng.uniform(-25, 25, (b, k, 2 * n))
    else:
        rows = np.zeros((b, k, 2 * n))
        rows[..., 0::2] = rng.uniform(3, 22, (b, k, n))
        rows[..., 1::2] = np.sort(rng.uniform(0, 2 * np.pi, (b, k, n)), -1)
    if radius:
        rows = np.concatenate([rows, rng.uniform(-6, 6, (b, k, 1))], -1)
    return rows.astype(np.float32)


def test_host_cases_of_the_jax_tests_are_equal():
    """tests/test_experimental_losses.py's cases, through both."""
    v = _octagon()
    for rep_row, rep in ((v, "cartesian"),
                         (np.ravel(np.stack([np.full(8, 10.0), np.sort(
                             np.linspace(0.1, 2 * np.pi - 0.1, 8))], 1)),
                          "polar")):
        for a, b in zip(texp.create_mask(rep_row, rep_row, H, W, rep),
                        jexp.create_mask(rep_row, rep_row, H, W, rep)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.float32
    mask = np.ones((1, 1))
    small = np.concatenate([v, [2.0]])[None, None, :]
    big = np.concatenate([v, [8.0]])[None, None, :]
    for p in (small, big):
        assert texp.disk_loss(p, mask, small, H, W) == \
            jexp.disk_loss(p, mask, small, H, W)
    assert texp.disk_loss(big, np.zeros((1, 1)), big, H, W) == (0.0, 0.0)
    centers = np.array([[[48, 32]]], np.float32)
    pts = [(v[j] + 48, v[j + 1] + 32) for j in range(0, 15, 2)]
    gt = jexp._fill_polygon(pts, H, W)
    np.testing.assert_array_equal(texp._fill_polygon(pts, H, W), gt)
    for target in (gt[None], np.zeros((1, H, W), np.float32)):
        assert texp.area_poly_loss(v[None, None], mask, target, centers) \
            == jexp.area_poly_loss(v[None, None], mask, target, centers)


@pytest.mark.parametrize("rep", REPS)
def test_host_losses_are_bit_equal_to_jax(rep):
    rng = np.random.RandomState(7 + REPS.index(rep))
    for trial in range(3):
        pred = _rows(rng, rep, 2, 4, 8, radius=True)
        target = _rows(rng, rep, 2, 4, 8, radius=True)
        mask = (rng.rand(2, 4) > 0.3).astype(np.float32)
        for i in range(4):
            for a, b in zip(
                    texp.create_mask(pred[0, i], target[0, i], H, W, rep),
                    jexp.create_mask(pred[0, i], target[0, i], H, W, rep)):
                np.testing.assert_array_equal(a, b)
        got = texp.disk_loss(pred, mask, target, H, W, rep)
        want = jexp.disk_loss(pred, mask, target, H, W, rep)
        assert got == want and got[0] > 0
        rows = _rows(rng, "cartesian", 2, 4, 8)
        centers = rng.uniform(-10, 110, (2, 4, 2)).astype(np.float32)
        target_mask = (rng.rand(2, H, W) > 0.7).astype(np.float32) * 255
        assert texp.area_poly_loss(rows, mask, target_mask, centers) == \
            jexp.area_poly_loss(rows, mask, target_mask, centers)


# -- the device half against JAX's -------------------------------------------

def _close(got, want, tol):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err


@pytest.mark.parametrize("rep", REPS)
def test_rep_to_xy_matches_jax(rep):
    rows = _rows(np.random.RandomState(3), rep, 2, 3, 8, radius=True)
    _close(texp._rep_to_xy(torch.from_numpy(rows), rep),
           jexp._rep_to_xy(jnp.asarray(rows), rep), 1e-6)


def test_soft_masks_match_jax():
    rng = np.random.RandomState(5)
    for tau in (0.25, 1.0, 3.0):
        v = (_octagon(12.0).reshape(-1, 2) + [48, 32]
             + rng.uniform(-3, 3, (8, 2))).astype(np.float32)
        _close(texp.soft_polygon_mask(torch.from_numpy(v), H, W, tau),
               jexp.soft_polygon_mask(jnp.asarray(v), H, W, tau), 1e-5)
        c = rng.uniform(0, 90, (6, 2)).astype(np.float32)
        _close(texp.soft_disks_mask(torch.from_numpy(c), torch.tensor(4.5),
                                    H, W, tau),
               jexp.soft_disks_mask(jnp.asarray(c), 4.5, H, W, tau), 1e-5)
    # the mask thresholds to Pillow's fill but for the boundary band
    v = _octagon(12.0).reshape(-1, 2) + np.array([48.0, 32.0])
    hard = texp._fill_polygon([tuple(p) for p in v], H, W) / 255.0
    soft = texp.soft_polygon_mask(torch.tensor(v, dtype=torch.float32),
                                  H, W, tau=0.25).numpy()
    assert np.mean((soft > 0.5) != (hard > 0.5)) < 0.02


def _grads(port_fn, jax_fn, pred):
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = port_fn(p)
    loss.backward()
    jl, jg = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
    return loss, p.grad, jl, jg


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("tau", [0.5, 1.0])
def test_disk_loss_device_and_gradient_match_jax(rep, tau):
    rng = np.random.RandomState(11 + REPS.index(rep))
    pred = _rows(rng, "cartesian", 2, 3, 8, radius=True)
    target = _rows(rng, rep, 2, 3, 8, radius=True)
    mask = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    tgt, m = torch.from_numpy(target), torch.from_numpy(mask)
    loss, g, jl, jg = _grads(
        lambda p: texp.disk_loss_device(p, m, tgt, H, W, rep, tau),
        lambda p: jexp.disk_loss_device(p, jnp.asarray(mask),
                                        jnp.asarray(target), H, W, rep, tau),
        pred)
    _close(loss, jl, 1e-5)
    _close(g, jg, 1e-4)
    assert np.abs(g.numpy()).max() > 0
    assert not g[0, 2].any() and not g[1, 1].any()     # masked slots


@pytest.mark.parametrize("rep", REPS)
def test_area_poly_loss_device_and_gradient_match_jax(rep):
    rng = np.random.RandomState(21 + REPS.index(rep))
    pred = _rows(rng, rep, 2, 3, 8)
    if rep == "cartesian":
        pred *= 0.6
    centers = rng.uniform(15, 75, (2, 3, 2)).astype(np.float32)
    mask = np.array([[1, 0, 1], [1, 1, 0]], np.float32)
    target = (rng.rand(2, H, W) > 0.5).astype(np.float32)
    c, m, t = (torch.from_numpy(a) for a in (centers, mask, target))
    for tau in (0.5, 1.0):
        loss, g, jl, jg = _grads(
            lambda p: texp.area_poly_loss_device(p, m, t, c, rep, tau),
            lambda p: jexp.area_poly_loss_device(
                p, jnp.asarray(mask), jnp.asarray(target),
                jnp.asarray(centers), rep, tau),
            pred)
        _close(loss, jl, 1e-5)
        _close(g, jg, 1e-4)
        assert np.abs(g.numpy()).max() > 0


def test_device_losses_order_as_the_host_diagnostic():
    """A bigger disk radius covers the octagon more (lower loss), and the
    matching GT mask scores lower than an empty one, as in JAX's tests."""
    v = _octagon()
    mask = torch.ones((1, 1))
    small = torch.tensor(np.concatenate([v, [2.0]])[None, None],
                         dtype=torch.float32)
    big = torch.tensor(np.concatenate([v, [8.0]])[None, None],
                       dtype=torch.float32)
    assert texp.disk_loss_device(big, mask, small, H, W) < \
        texp.disk_loss_device(small, mask, small, H, W)
    pts = [(v[j] + 48, v[j + 1] + 32) for j in range(0, 15, 2)]
    match = torch.from_numpy(texp._fill_polygon(pts, H, W)[None] / 255.0)
    pv = torch.tensor(v[None, None], dtype=torch.float32)
    ctr = torch.tensor([[[48.0, 32.0]]])
    assert texp.area_poly_loss_device(pv, mask, match, ctr) < \
        texp.area_poly_loss_device(pv, mask, torch.zeros(1, H, W), ctr)
