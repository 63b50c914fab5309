"""Oracle-eval support: flood GT head values over the output map (the JAX
package's utils/oracle.py, host numpy on NHWC maps).

Behavioral reference: src/lib/utils/oracle_utils.py:8-42 (numba BFS) wired
through trains/polydet.py:49-70 — replaces any predicted head map with a
map where every pixel holds the GT value of the nearest (BFS) annotated
peak, so `--eval_oracle_*` flags can decouple head contributions.

Implemented as a vectorized nearest-seed assignment (equivalent result to
the reference's 4-neighborhood BFS up to distance ties) — no numba needed.
"""
from __future__ import annotations

import numpy as np


def gen_oracle_map(feat: np.ndarray, ind: np.ndarray, w: int,
                   h: int) -> np.ndarray:
    """feat: (B, K, D) GT values; ind: (B, K) flat peak indices.
    Returns (B, H, W, D) maps (NHWC; the reference emits NCHW)."""
    b, k, d = feat.shape
    out = np.zeros((b, h, w, d), dtype=feat.dtype)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for i in range(b):
        valid = ind[i] > 0
        if not valid.any():
            continue
        py = (ind[i][valid] // w).astype(np.int64)
        px = (ind[i][valid] % w).astype(np.int64)
        vals = feat[i][valid]
        # nearest seed in manhattan distance (BFS metric)
        dist = (np.abs(ys[..., None] - py[None, None, :])
                + np.abs(xs[..., None] - px[None, None, :]))
        nearest = np.argmin(dist, axis=-1)
        out[i] = vals[nearest]
    return out


def apply_oracles(outputs, batch, cfg):
    """Substitute GT for flagged heads (ref trains/polydet.py:49-70)."""
    out = dict(outputs)
    h, w = batch["hm"].shape[1:3]
    if getattr(cfg, "eval_oracle_hm", False):
        out["hm"] = batch["hm"]
    if getattr(cfg, "eval_oracle_offset", False) and "reg" in out:
        out["reg"] = gen_oracle_map(
            np.asarray(batch["reg"]), np.asarray(batch["ind"]), w, h)
    if getattr(cfg, "eval_oracle_poly", False):
        out["poly"] = gen_oracle_map(
            np.asarray(batch["poly"]), np.asarray(batch["ind"]), w, h)
    if getattr(cfg, "eval_oracle_pseudo_depth", False):
        out["pseudo_depth"] = gen_oracle_map(
            np.asarray(batch["pseudo_depth"]), np.asarray(batch["ind"]),
            w, h)
    return out
