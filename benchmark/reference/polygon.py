"""Fixed-shape, differentiable polygon geometry of the polygon IoU loss.

area(P ∩ Q) = | Σ_i Σ_j s_i s_j area(T_i ∩ T_j) | over the fan triangles
T_i = (O, p_i, p_{i+1}) from a fixed origin, s_i the sign of each
triangle's signed area; the convex triangle-pair area is closed form
(Green's theorem over each edge clipped by the other triangle's
half-planes).  Batch dimensions broadcast, so the whole (B, K) object grid
is one computation.

At its non-smooth points clips and max/min ties split the gradient
evenly (torch.maximum / torch.minimum, never Tensor.clamp; amax / amin),
and |x| has gradient 1 at 0 (`abs_`; torch.abs gives 0).

Polygons are (..., N, 2) arrays of (x, y); polar points are (r, theta).
"""
from __future__ import annotations

import torch

_EPS = 1e-9
# collinearity threshold in distance units (constraint values are
# normalised by the constraint edge length)
_COLLINEAR_EPS = 1e-4


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """minimum(maximum(x, lo), hi): 0.5 of the gradient at a tie with
    either bound."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with gradient +1 for x >= 0 (so 1 at 0), -1 below."""
    return torch.where(x >= 0, x, -x)


def polar_to_cartesian(poly_rt: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) (r, theta) -> (x, y) = (r cos t, r sin t)."""
    r, t = poly_rt[..., 0], poly_rt[..., 1]
    return torch.stack([r * torch.cos(t), r * torch.sin(t)], dim=-1)


def signed_area(poly: torch.Tensor) -> torch.Tensor:
    x, y = poly[..., 0], poly[..., 1]
    xn, yn = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    return 0.5 * torch.sum(x * yn - y * xn, dim=-1)


def polygon_area(poly: torch.Tensor) -> torch.Tensor:
    """Unsigned shoelace area of (..., N, 2) cartesian polygons."""
    return abs_(signed_area(poly))


def _edge_clip_contrib(sa, da, eb, db):
    """Green's-theorem contribution of CCW-polygon-A edges clipped by B:
    each edge (sa, sa+da) of A is cut to the part left of every directed
    edge (eb, eb+db) of B, and its sub-segment adds cross(s, e)/2.
    Segments lying on a constraint line weigh 1/2: the pass over B's
    edges adds the same (coincident, same direction) or the negated
    (opposite direction) contribution (experiments/RESULTS.md,
    "Closed-form polygon-IoU loss").

    sa, da: (..., E, 2); eb, db: (..., C, 2).  Returns (...,)."""
    sa_, da_ = sa[..., :, None, :], da[..., :, None, :]
    eb_, db_ = eb[..., None, :, :], db[..., None, :, :]

    c1 = db_[..., 0] * da_[..., 1] - db_[..., 1] * da_[..., 0]
    rel = sa_ - eb_
    c0 = db_[..., 0] * rel[..., 1] - db_[..., 1] * rel[..., 0]
    inv_len = torch.rsqrt(torch.maximum(db_[..., 0] ** 2 + db_[..., 1] ** 2,
                                        c0.new_tensor(_EPS)))
    c0n = c0 * inv_len
    c1n = c1 * inv_len

    parallel = torch.abs(c1n) <= _COLLINEAR_EPS
    on_line = parallel & (torch.abs(c0n) <= _COLLINEAR_EPS)
    outside = parallel & (c0n < -_COLLINEAR_EPS)

    safe_c1 = torch.where(torch.abs(c1) < _EPS, _EPS, c1)
    ratio = -c0 / safe_c1
    lo = torch.where(~parallel & (c1 > 0), ratio, 0.0)
    hi = torch.where(~parallel & (c1 < 0), ratio, 1.0)
    lo = torch.where(outside, 2.0, lo)   # empty interval
    hi = torch.where(outside, -1.0, hi)

    t0 = clip(torch.amax(lo, dim=-1), 0.0, 1.0)   # (..., E)
    t1 = clip(torch.amin(hi, dim=-1), 0.0, 1.0)
    keep = (t1 > t0).to(sa.dtype)
    weight = torch.where(torch.any(on_line, dim=-1), 0.5, 1.0).to(sa.dtype)

    s = sa + t0[..., None] * da
    e = sa + t1[..., None] * da
    contrib = 0.5 * (s[..., 0] * e[..., 1] - s[..., 1] * e[..., 0])
    return torch.sum(contrib * keep * weight, dim=-1)


def _convex_pair_area(tri_a: torch.Tensor, tri_b: torch.Tensor
                      ) -> torch.Tensor:
    """Intersection area of batched convex CCW polygons (..., V, 2)."""
    sa, da = tri_a, torch.roll(tri_a, -1, dims=-2) - tri_a
    sb, db = tri_b, torch.roll(tri_b, -1, dims=-2) - tri_b
    area = (_edge_clip_contrib(sa, da, sb, db)
            + _edge_clip_contrib(sb, db, sa, da))
    return torch.maximum(area, torch.zeros_like(area))


def _ccw(tris: torch.Tensor) -> torch.Tensor:
    """Orient batched triangles (..., 3, 2) counter-clockwise."""
    flip = signed_area(tris) < 0
    swapped = tris[..., [0, 2, 1], :]
    return torch.where(flip[..., None, None], swapped, tris)


def _fan(poly: torch.Tensor):
    tris = torch.stack([torch.zeros_like(poly), poly,
                        torch.roll(poly, -1, dims=-2)], dim=-2)
    return tris, torch.sign(signed_area(tris))


def polygon_intersection_area(p: torch.Tensor, q: torch.Tensor
                              ) -> torch.Tensor:
    """Exact area of intersection of two simple polygons, fixed shape.
    p: (..., N, 2), q: (..., M, 2) with matching batch dims."""
    n, m = p.shape[-2], q.shape[-2]
    tp, sp = _fan(p)
    tq, sq = _fan(q)
    tp, tq = _ccw(tp), _ccw(tq)
    batch = tp.shape[:-3]
    pair_area = _convex_pair_area(
        tp[..., :, None, :, :].expand(*batch, n, m, 3, 2),
        tq[..., None, :, :, :].expand(*batch, n, m, 3, 2))
    total = torch.sum(sp[..., :, None] * sq[..., None, :] * pair_area,
                      dim=(-1, -2))
    return abs_(total)


def polygon_iou(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """IoU of two simple polygons (batch dims broadcast) with the
    reference's fallback: an intersection of ~0 becomes min(area_p,
    area_q) (losses.py:884-886)."""
    inter = polygon_intersection_area(p, q)
    ap, aq = polygon_area(p), polygon_area(q)
    inter = torch.where(inter <= _EPS, torch.minimum(ap, aq), inter)
    return inter / (ap + aq - inter + 1e-6)
