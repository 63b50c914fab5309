"""The port's oracle-free convergence harness
(centerpoly_tpu_torch/tools/train_convergence.py) against the JAX
package's (experiments/train_convergence.py), on the CPU.

* `make_dataset` writes JAX's fixture: the same pixels (the port draws the
  rectangles by slicing and writes PNG without cv2), the same ann.json
  bytes and the same GT instance images;
* the fixture's `run_eval` gives JAX's evaluator dict on the same
  results;
* a one-epoch `run()` at 64x128 on 4 images returns JAX's result keys
  (with `eval_dcn` and `offset_r` on DLA-34, which runs the DCN paths);
* the full res_18 run of tests/test_convergence.py (AP50 >= 0.5 and AP >
  0.15 within 40 epochs) is `slow`, as JAX's is.
"""
import json
import os
import sys

import numpy as np
import pytest

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import train_convergence as jconv  # noqa: E402
from centerpoly_tpu.data.datasets import CityscapesMeta as JaxMeta  # noqa: E402
from centerpoly_tpu.eval.harness import run_instance_eval  # noqa: E402
from centerpoly_tpu_torch.tools import train_convergence as tconv  # noqa: E402

JAX_KEYS = {"arch", "rep", "poly_loss", "images", "input", "epochs_run",
            "steps", "ap_trajectory", "final_ap", "final_ap50", "bar",
            "passed", "wall_s"}
DCN_KEYS = {"eval_dcn", "eval_dcn_ap", "eval_dcn_ap50",
            "eval_dcn_ap50_delta", "offset_stats_r", "offset_stats",
            "worst_node_frac_y_clamped"}


@pytest.mark.parametrize("n,h,w", [(8, 128, 256), (3, 64, 128)])
def test_make_dataset_is_jaxs(tmp_path, n, h, w):
    ref = jconv.make_dataset(str(tmp_path / "jax"), n, 0, h, w)
    got = tconv.make_dataset(str(tmp_path / "port"), n, 0, h, w)
    with open(ref[0], "rb") as a, open(got[0], "rb") as b:
        assert a.read() == b.read()
    assert sorted(os.listdir(ref[1])) == sorted(os.listdir(got[1]))
    for name in os.listdir(ref[1]):
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(got[1], name)),
            cv2.imread(os.path.join(ref[1], name)))
    assert ref[2].keys() == got[2].keys()
    for k in ref[2]:
        assert got[2][k].dtype == ref[2][k].dtype
        np.testing.assert_array_equal(got[2][k], ref[2][k])


def _results(ann_path, rng):
    """Per image {class: rows}: each GT rectangle's polygon, jittered by up
    to 3 px and scored at random, as class 3 (car), plus a false positive
    of class 1."""
    with open(ann_path) as f:
        ann = json.load(f)
    res = {im["id"]: {c: np.zeros((0, 38), np.float32) for c in range(1, 9)}
           for im in ann["images"]}
    for a in ann["annotations"]:
        poly = np.asarray(a["poly"], np.float32) + rng.uniform(-3, 3, 32)
        x0, y0, bw, bh = a["bbox"]
        row = np.concatenate([[x0, y0, x0 + bw, y0 + bh, rng.rand()], poly,
                              [a["pseudo_depth"]]]).astype(np.float32)
        res[a["image_id"]][3] = np.vstack([res[a["image_id"]][3], row])
    for per in res.values():
        row = np.concatenate([[10, 10, 40, 30, 0.9], rng.uniform(10, 40, 32),
                              [0]]).astype(np.float32)
        per[1] = row[None]
    return res


def test_fixture_run_eval_is_jaxs(tmp_path):
    ann_path, _, gt_images = tconv.make_dataset(str(tmp_path), 4, 1, 64, 128)
    results = _results(ann_path, np.random.RandomState(0))

    class JaxFixtureMeta(JaxMeta):
        eval_image_size = (64, 128)

    ref = run_instance_eval(JaxFixtureMeta(str(tmp_path)), results,
                            str(tmp_path / "jax"), gt_images=gt_images)
    meta = tconv.FixtureMeta(str(tmp_path), gt_images, (64, 128))
    got = meta.run_eval(results, str(tmp_path / "port"))
    assert got is meta.last_res and 0 < got["allAp50%"] <= 1
    # classes without GT score NaN on both sides (NaN != NaN in a dict)
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_one_epoch_returns_jaxs_keys(tmp_path):
    res = tconv.run(arch="res_18", epochs=1, n_images=4, input_h=64,
                    input_w=128, root=str(tmp_path / "res"), device="cpu")
    assert set(res) == JAX_KEYS
    assert res["epochs_run"] == 1 and res["steps"] == 1
    assert [t["epoch"] for t in res["ap_trajectory"]] == [1]
    res = tconv.run(arch="dla_34", epochs=1, n_images=4, input_h=64,
                    input_w=128, root=str(tmp_path / "dla"), device="cpu",
                    eval_dcn="rowband:4", offset_r=4)
    assert set(res) == JAX_KEYS | DCN_KEYS
    assert len(res["offset_stats"]) == 16
    assert res["eval_dcn_ap50_delta"] == round(
        res["eval_dcn_ap50"] - res["final_ap50"], 6)


def test_main_prints_the_result(tmp_path, capsys, monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the fixture
    res = tconv.main(["--arch", "res_18", "--epochs", "1", "--images", "4",
                      "--input_h", "64", "--input_w", "128", "--device",
                      "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("RESULT ") and set(res) == JAX_KEYS


@pytest.mark.slow
def test_training_learns_detector_oracle_free(tmp_path):
    """tests/test_convergence.py's run and bars, on the port."""
    res = tconv.run(arch="res_18", rep="cartesian", poly_loss="l1",
                    epochs=40, n_images=8, input_h=128, input_w=256,
                    batch_size=4, lr=2.5e-4, bar=0.5, val_every=5,
                    root=str(tmp_path), device="cpu")
    assert res["passed"], (
        f"AP50 {res['final_ap50']:.3f} < 0.5 after {res['steps']} steps: "
        f"trajectory {res['ap_trajectory']}")
    assert res["final_ap"] > 0.15, res
