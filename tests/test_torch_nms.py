"""The on-device NMS of the PyTorch port (`ops/nms.py` `soft_nms_batch`,
`hard_nms_batch`) against the JAX package's (CPU), with the cases of the
JAX package's tests/test_ops.py:

* `soft_nms_batch` on random boxes: the decayed scores equal JAX's
  within 1e-6 and, as a set, the host `soft_nms`'s within rtol 1e-4 (its
  own test's bound); tied scores (`argmax` takes the first maximum in
  both packages) and duplicated boxes; scores below `thresh` come back
  as 0; K = 1;
* `hard_nms_batch`: the keep mask in the input order equal to JAX's and
  to a greedy reference, with tied scores (a stable sort in both) and
  K = 1;
* both exported from `ops` as in the JAX package, and run on the
  tensor's own device (the CPU here).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.ops import nms as jnms
from centerpoly_tpu_torch import ops as tops
from centerpoly_tpu_torch.ops import nms as tnms


def _boxes(seed, n, spread=50.0, size=(5.0, 20.0)):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * spread
    wh = rng.rand(n, 2) * (size[1] - size[0]) + size[0]
    return (np.concatenate([xy, xy + wh], 1).astype(np.float32),
            rng.rand(n).astype(np.float32))


def _ties(boxes, scores):
    """Every third score and score 1 tied to the first, and box 1 a copy of
    box 0."""
    scores = scores.copy()
    scores[::3] = scores[0]
    scores[1] = scores[0]
    boxes = boxes.copy()
    boxes[1] = boxes[0]
    return boxes, scores


SOFT_CASES = {"random": (3, 16, False), "ties": (4, 24, True),
              "dense": (5, 64, False), "one": (6, 1, False)}


@pytest.mark.parametrize("case", sorted(SOFT_CASES))
def test_soft_nms_batch_matches_jax_and_host(case):
    seed, n, ties = SOFT_CASES[case]
    boxes, scores = _boxes(seed, n, spread=30.0 if n > 32 else 50.0)
    if ties:
        boxes, scores = _ties(boxes, scores)
    for thresh in (0.0, 0.001, 0.3):
        got = tnms.soft_nms_batch(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), thresh=thresh)
        ref = np.asarray(jnms.soft_nms_batch(jnp.asarray(boxes),
                                             jnp.asarray(scores),
                                             thresh=thresh))
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
        g = got.numpy()
        assert ((g == 0) | (g >= thresh)).all()
        if thresh > 0:
            assert (g[(g > 0)] >= thresh).all()
    host = np.concatenate([boxes, scores[:, None]], 1)
    tnms.soft_nms(host, method=2, thresh=0.0)
    dev = tnms.soft_nms_batch(torch.from_numpy(boxes),
                              torch.from_numpy(scores), thresh=0.0).numpy()
    np.testing.assert_allclose(np.sort(dev), np.sort(host[:, 4]), rtol=1e-4)


def test_soft_nms_batch_decays_an_overlap():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    got = tnms.soft_nms_batch(torch.from_numpy(boxes),
                              torch.from_numpy(scores)).numpy()
    np.testing.assert_allclose(got, [0.9, 0.8 * np.exp(-1 / 0.5), 0.7],
                               rtol=1e-6)


def _greedy(boxes, scores, t):
    order = np.argsort(-scores, kind="stable")
    kept = np.zeros(len(scores), bool)
    chosen = []
    for i in order:
        ok = True
        for j in chosen:
            x1, y1 = max(boxes[i, 0], boxes[j, 0]), max(boxes[i, 1],
                                                        boxes[j, 1])
            x2, y2 = min(boxes[i, 2], boxes[j, 2]), min(boxes[i, 3],
                                                        boxes[j, 3])
            inter = max(x2 - x1, 0) * max(y2 - y1, 0)
            a = ((boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
                 + (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1]))
            if inter / max(a - inter, 1e-9) > t:
                ok = False
                break
        if ok:
            chosen.append(i)
            kept[i] = True
    return kept


HARD_CASES = {"random": (0, 32, False, 0.5), "ties": (1, 32, True, 0.5),
              "loose": (2, 48, False, 0.1), "one": (3, 1, False, 0.7)}


@pytest.mark.parametrize("case", sorted(HARD_CASES))
def test_hard_nms_batch_matches_jax_and_greedy(case):
    seed, n, ties, t = HARD_CASES[case]
    rng = np.random.RandomState(seed)
    centers = rng.rand(n, 2) * 100
    wh = rng.rand(n, 2) * 20 + 5
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        boxes, scores = _ties(boxes, scores)
    got = tnms.hard_nms_batch(torch.from_numpy(boxes),
                              torch.from_numpy(scores), t)
    ref = np.asarray(jnms.hard_nms_batch(jnp.asarray(boxes),
                                         jnp.asarray(scores), t))
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), _greedy(boxes, scores, t))
    assert got.numpy()[np.argmax(scores)]
    if ties:
        assert not got.numpy()[1]       # box 1 copies box 0, tied, later


def test_exported_as_in_jax():
    assert tops.soft_nms_batch is tnms.soft_nms_batch
    assert tops.hard_nms_batch is tnms.hard_nms_batch
    assert tops.soft_nms is tnms.soft_nms
