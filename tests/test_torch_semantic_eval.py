"""The pixel-level Cityscapes semantic evaluator of the PyTorch port
(`eval/semantic_eval.py`) against the JAX package's (CPU): on seeded
label-id and instance-id maps (every label id, ignored ones included,
rectangles of instance classes with ids class * 1000 + k, predictions
with confusions), `evaluate_semantic` with and without instance pairs,
through the native confusion loop and through numpy (the library's
loader made to find no build, as where cpp/ cannot build), equals JAX's:
the confusion matrix exactly, every class, category and average score
(IoU and iIoU) within 1e-12, nan where JAX's is nan."""
import numpy as np
import pytest

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.eval import semantic_eval as jsem
from centerpoly_tpu_torch.eval import native
from centerpoly_tpu_torch.eval import semantic_eval as tsem

INSTANCE_IDS = [l.id for l in tsem.SEMANTIC_LABELS
                if l.has_instances and not l.ignore_in_eval]


def _pair(rng, h=96, w=160, n_inst=6):
    """(prediction, GT labelIds, GT instanceIds): a background of random
    label ids in 8x8 blocks, instance rectangles on it, and a prediction
    that keeps ~70 % of the GT and relabels the rest at random."""
    blocks = rng.randint(0, 34, (h // 8, w // 8))
    gt = np.kron(blocks, np.ones((8, 8), np.int64)).astype(np.uint8)
    inst = gt.astype(np.int32)
    for k in range(n_inst):
        cls = INSTANCE_IDS[rng.randint(len(INSTANCE_IDS))]
        y0, x0 = rng.randint(0, h - 12), rng.randint(0, w - 12)
        y1, x1 = y0 + rng.randint(4, 24), x0 + rng.randint(4, 40)
        gt[y0:y1, x0:x1] = cls
        inst[y0:y1, x0:x1] = cls * 1000 + k
    # instance ids only where the GT holds an instance class
    plain = ~np.isin(gt, INSTANCE_IDS)
    inst[plain] = gt[plain]
    pred = gt.copy()
    flip = rng.rand(h, w) < 0.3
    pred[flip] = rng.randint(0, 34, int(flip.sum()))
    return pred, gt, inst


def _same(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if k == "confMatrix":
            assert got[k].dtype == np.uint64
            np.testing.assert_array_equal(got[k], ref[k])
        elif isinstance(ref[k], dict):
            assert set(got[k]) == set(ref[k]), k
            for name in ref[k]:
                np.testing.assert_allclose(got[k][name], ref[k][name],
                                           rtol=1e-12, atol=1e-12,
                                           err_msg=f"{k} {name}")
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)


def _numpy_only(monkeypatch):
    """The confusion loop's library unavailable: numpy's bincount path."""
    monkeypatch.setattr(native, "_load", lambda build_dir=None: None)


@pytest.mark.parametrize("native_loop", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("with_instances", [True, False],
                         ids=["iiou", "iou"])
def test_evaluate_semantic_matches_jax(monkeypatch, native_loop,
                                       with_instances):
    if native_loop:
        assert native._load() is not None, native.last_build_error
    else:
        _numpy_only(monkeypatch)
    rng = np.random.RandomState(7)
    triples = [_pair(rng) for _ in range(3)]
    pairs = [(p, g) for p, g, _ in triples]
    inst = [(p, i) for p, _, i in triples] if with_instances else None
    got = tsem.evaluate_semantic(pairs, inst)
    ref = jsem.evaluate_semantic(pairs, inst)
    _same(got, ref)
    assert np.isnan(got["classScores"]["unlabeled"])
    assert 0 < got["averageScoreClasses"] < 1
    if with_instances:
        assert 0 < got["averageScoreInstClasses"] < 1


def test_native_and_numpy_confusion_are_equal(monkeypatch):
    rng = np.random.RandomState(8)
    pairs = [(p, g) for p, g, _ in (_pair(rng) for _ in range(2))]
    # labels >= 34 are dropped by both
    pairs[0][0][:4, :4] = 255
    assert native._load() is not None, native.last_build_error
    a = tsem.accumulate_confusion(pairs)
    _numpy_only(monkeypatch)
    b = tsem.accumulate_confusion(pairs)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, jsem.accumulate_confusion(pairs))
    assert a.shape == (34, 34) and int(a.sum()) == 2 * 96 * 160 - 16


def test_label_table_and_constants_equal_jax():
    assert [tuple(vars(l).values()) for l in tsem.SEMANTIC_LABELS] == [
        tuple(vars(l).values()) for l in jsem.SEMANTIC_LABELS]
    assert tsem.AVG_CLASS_SIZE == jsem.AVG_CLASS_SIZE
    assert tsem.INSTANCE_CATEGORIES == jsem.INSTANCE_CATEGORIES
    assert {c: [l.id for l in ls] for c, ls in tsem.CATEGORY2LABELS.items()
            } == {c: [l.id for l in ls]
                  for c, ls in jsem.CATEGORY2LABELS.items()}
