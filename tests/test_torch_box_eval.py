"""The box evaluators of the PyTorch port (eval/coco_eval.py, voc_eval.py,
native.py and the box metas of data/datasets.py) against the JAX
package's, on seeded GT and detections.

The detections carry ties (scores repeated within and across images),
the GT crowd and difficult boxes and boxes in each COCO area range, so
the stable sorts, COCO's greedy matching and the VOC difficult rule all
decide the numbers.  Both packages run the same numpy in the same order,
so every number must be equal, not close.  The native evaluator and the
confusion-matrix loop are the repo's own cpp/ sources, built by each
package into its own directory.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.data import CocoPolyAnnotations as JAnnotations
from centerpoly_tpu.data.datasets import DATASETS as JDATASETS
from centerpoly_tpu.eval import coco_eval as jcoco
from centerpoly_tpu.eval import native as jnative
from centerpoly_tpu.eval import voc_eval as jvoc
from centerpoly_tpu_torch.data import CocoPolyAnnotations
from centerpoly_tpu_torch.data.datasets import DATASETS, eval_kwargs
from centerpoly_tpu_torch.eval import coco_eval, native, voc_eval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_METAS = ("coco", "pascal", "uadetrac", "uadetrac1on10",
             "uadetrac1on10_b", "uav")


def _gt(n_images=6, cats=(1, 2, 3), seed=0):
    """COCO-json GT: boxes small (< 32^2), medium and large, some crowd,
    some difficult."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n_images):
        images.append({"id": 10 + i, "file_name": f"im{i}.jpg",
                       "height": 400, "width": 600})
        for _ in range(rng.randint(1, 6)):
            side = rng.choice([20.0, 60.0, 150.0])
            w, h = side * rng.uniform(0.6, 1.4), side * rng.uniform(0.6, 1.4)
            x, y = rng.uniform(0, 600 - w), rng.uniform(0, 400 - h)
            anns.append({"id": len(anns), "image_id": 10 + i,
                         "category_id": int(rng.choice(cats)),
                         "bbox": [float(x), float(y), float(w), float(h)],
                         "area": float(w * h),
                         "iscrowd": int(rng.rand() < 0.1),
                         "difficult": int(rng.rand() < 0.15)})
    return {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in cats]}


def _dets(gt, seed=1):
    """{img_id: {cat: (n, 5)}}: jittered GT boxes, duplicates, false
    positives; scores on a grid of 0.1 so many tie."""
    rng = np.random.RandomState(seed)
    out = {}
    for a in gt["annotations"]:
        x, y, w, h = a["bbox"]
        rows = out.setdefault(a["image_id"], {}).setdefault(
            a["category_id"], [])
        for _ in range(rng.randint(0, 3)):
            j = rng.randn(4) * 0.08 * np.array([w, h, w, h])
            rows.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3],
                         round(rng.uniform(0.1, 1.0), 1)])
    for img in gt["images"]:
        for _ in range(rng.randint(0, 3)):
            x, y = rng.uniform(0, 500), rng.uniform(0, 300)
            out.setdefault(img["id"], {}).setdefault(
                int(rng.choice([1, 2, 3])), []).append(
                [x, y, x + 50, y + 40, round(rng.uniform(0.1, 1.0), 1)])
    return {i: {c: np.asarray(r, np.float32) for c, r in pc.items()}
            for i, pc in out.items()}


@pytest.fixture(scope="module")
def gt_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gt") / "gt.json")
    with open(path, "w") as f:
        json.dump(_gt(), f)
    return path


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("max_dets", [100, 2])
def test_coco_map_areas_equal_jax(gt_path, seed, max_dets):
    gt = json.load(open(gt_path))
    dets = _dets(gt, seed)
    got = coco_eval.evaluate_coco_map_areas(CocoPolyAnnotations(gt_path),
                                            dets, max_dets)
    ref = jcoco.evaluate_coco_map_areas(JAnnotations(gt_path), dets, max_dets)
    assert got == ref
    assert set(got) == {"AP", "AP50", "AP75", "AR100", "APs", "APm", "APl"}
    assert 0 < got["AP"] < 1


def test_bbox_iou_and_match_equal_jax():
    rng = np.random.RandomState(4)
    d = np.concatenate([rng.rand(7, 2) * 50, rng.rand(7, 2) * 50 + 50], 1)
    g = np.concatenate([rng.rand(5, 2) * 50, rng.rand(5, 2) * 50 + 50], 1)
    crowd = np.array([0, 1, 0, 0, 1], bool)
    np.testing.assert_array_equal(coco_eval.bbox_iou_matrix(d, g, crowd),
                                  jcoco.bbox_iou_matrix(d, g, crowd))
    dets = np.concatenate([d, np.round(rng.rand(7, 1), 1)], 1)
    ignore = np.array([0, 1, 0, 1, 0], np.float32)
    for a, b in zip(coco_eval._match_image(dets, g, ignore, crowd, 10),
                    jcoco._match_image(dets, g, ignore, crowd, 10)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_07", [True, False])
@pytest.mark.parametrize("seed", [1, 2])
def test_voc_map_equal_jax(gt_path, use_07, seed):
    gt = json.load(open(gt_path))
    dets = _dets(gt, seed)
    names = ["__background__", "a", "b", "c"]
    got = voc_eval.evaluate_voc_map(CocoPolyAnnotations(gt_path), dets,
                                    use_07_metric=use_07, class_names=names)
    ref = jvoc.evaluate_voc_map(JAnnotations(gt_path), dets,
                                use_07_metric=use_07, class_names=names)
    assert got == ref and 0 < got["AP"] < 1


def test_voc_ap_and_class_rule_equal_jax():
    rng = np.random.RandomState(5)
    rec = np.sort(rng.rand(30))
    prec = rng.rand(30)
    for use_07 in (True, False):
        assert voc_eval.voc_ap(rec, prec, use_07) == jvoc.voc_ap(rec, prec,
                                                                 use_07)
    gts = {0: np.array([[0.0, 0.0, 10.0, 10.0], [50.0, 50.0, 60.0, 60.0]])}
    difficult = {0: np.array([False, True])}
    dets = {0: np.array([[0.0, 0.0, 10.0, 10.0, 0.9],
                         [50.0, 50.0, 60.0, 60.0, 0.8],
                         [0.0, 0.0, 10.0, 10.0, 0.8],
                         [200.0, 200.0, 210.0, 210.0, 0.6]])}
    got = voc_eval.voc_eval_class(dets, gts, difficult)
    ref = jvoc.voc_eval_class(dets, gts, difficult)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _box_root(tmp_path, name, gt):
    """Write `gt` where the meta `name` reads its val annotations."""
    meta = DATASETS[name](str(tmp_path))
    path = meta.annot_path("val")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(gt, f)
    return meta, JDATASETS[name](str(tmp_path))


def _tree(d):
    return {os.path.relpath(os.path.join(p, f), d):
            open(os.path.join(p, f), "rb").read()
            for p, _, fs in os.walk(d) for f in fs}


@pytest.mark.parametrize("name", BOX_METAS)
def test_box_meta_run_eval_writes_what_jax_does(tmp_path, name):
    """run_eval of each box meta on the same results: the same return and
    byte-equal files; the keywords the CLIs pass it are none."""
    meta, jmeta = _box_root(tmp_path, name, _gt(cats=(1, 2, 3)))
    # contiguous class ids (1-based), as the detectors emit them
    dets = {i: {c: r for c, r in pc.items()}
            for i, pc in _dets(_gt(cats=(1, 2, 3)), 1).items()}
    assert eval_kwargs(meta, annotations=object(), thresh=0.1) == {}
    got = meta.run_eval(dets, str(tmp_path / "port"))
    ref = jmeta.run_eval(dets, str(tmp_path / "jax"))
    assert got == ref
    files = _tree(str(tmp_path / "port"))
    assert files == _tree(str(tmp_path / "jax"))
    want = ({"coco_eval.json"} if name == "coco"
            else {"voc_eval.json", "coco_protocol_eval.json"})
    assert set(files) == want


def test_polygon_meta_takes_annotations_and_thresh():
    meta = DATASETS["cityscapes"]("")
    ann = object()
    assert eval_kwargs(meta, annotations=ann, thresh=0.2) == {
        "annotations": ann, "thresh": 0.2}


def _kitti_results(n=45, seed=6):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(n):
        out[i] = {}
        for cls in (1, 2, 3):
            x0, y0 = rng.uniform(0, 900), rng.uniform(0, 200)
            rows = [[x0, y0, x0 + rng.uniform(30, 200),
                     y0 + rng.uniform(40, 150), rng.rand()]
                    for _ in range(rng.randint(0, 3))]
            out[i][cls] = np.asarray(rows, np.float32).reshape(-1, 5)
    return out


def _kitti_gt(gt_dir, results, seed=7):
    """KITTI label files: each result box, jittered, as the GT of its
    class (Pedestrian / Car / Cyclist), and a DontCare row."""
    rng = np.random.RandomState(seed)
    os.makedirs(gt_dir, exist_ok=True)
    names = {1: "Pedestrian", 2: "Car", 3: "Cyclist"}
    for i, per_class in results.items():
        with open(os.path.join(gt_dir, f"{i:06d}.txt"), "w") as f:
            for cls, rows in per_class.items():
                for r in rows:
                    j = rng.randn(4) * 3
                    f.write(f"{names[cls]} 0.0 0 0.5 {r[0] + j[0]:.2f} "
                            f"{r[1] + j[1]:.2f} {r[2] + j[2]:.2f} "
                            f"{r[3] + j[3]:.2f} 1.5 1.7 4.0 1.0 1.6 10.0 "
                            f"0.3\n")
            f.write("DontCare -1 -1 -10 5.0 5.0 20.0 20.0 -1 -1 -1 -1000 "
                    "-1000 -1000 -10\n")


def test_kitti2d_writer_and_native_eval_equal_jax(tmp_path):
    """The Kitti2dMeta writer's files byte-equal to JAX's; run_kitti_eval
    of the port's own build (centerpoly_tpu_torch/_build/native) on them
    equal to the JAX package's (cpp/build); run_eval with GT labels."""
    assert native.ensure_built(), native.last_build_error
    results = _kitti_results()
    meta, jmeta = DATASETS["kitti2d"](str(tmp_path)), JDATASETS["kitti2d"](
        str(tmp_path))
    meta.write_kitti_results(results, str(tmp_path / "port"))
    jmeta.write_kitti_results(results, str(tmp_path / "jax"))
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    gt_dir = str(tmp_path / "gt")
    _kitti_gt(gt_dir, results)
    got = native.run_kitti_eval(gt_dir, str(tmp_path / "port"))
    ref = jnative.run_kitti_eval(gt_dir, str(tmp_path / "jax"))
    assert got == ref and set(got) == {"car", "pedestrian", "cyclist"}
    assert 0 < got["car"]["detection"][0] <= 100
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    res = meta.run_eval(results, str(tmp_path / "out"), gt_label_dir=gt_dir)
    assert res == got
    assert meta.run_eval(results, str(tmp_path / "none")) is None


def test_kitti_ddd_writer_equal_jax(tmp_path):
    rng = np.random.RandomState(8)
    results = {i: {c: rng.randn(2, 13).astype(np.float32) for c in (1, 2, 3)}
               for i in range(3)}
    DATASETS["kitti"](str(tmp_path)).write_kitti_results(
        results, str(tmp_path / "port"))
    JDATASETS["kitti"](str(tmp_path)).write_kitti_results(
        results, str(tmp_path / "jax"))
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))


def test_confusion_matrix_equal_jax():
    rng = np.random.RandomState(9)
    pred = rng.randint(0, 24, (64, 96)).astype(np.uint8)
    gt = rng.randint(0, 24, (64, 96)).astype(np.uint8)
    assert native._load() is not None, native.last_build_error
    got = native.add_to_confusion_matrix(pred, gt, np.zeros((20, 20),
                                                            np.uint64))
    ref = jnative.add_to_confusion_matrix(pred, gt, np.zeros((20, 20),
                                                             np.uint64))
    np.testing.assert_array_equal(got, ref)
    # the numpy rule the native loop replaces
    valid = (gt < 20) & (pred < 20)
    want = np.zeros((20, 20), np.uint64)
    np.add.at(want, (gt[valid], pred[valid]), 1)
    np.testing.assert_array_equal(got, want)


_BUILD = """
import sys
from centerpoly_tpu_torch.eval import native
ok = native.ensure_built(build_dir=sys.argv[1])
print(ok, native.last_build_error)
"""


def test_two_processes_building_at_once_leave_one_sound_build(tmp_path):
    """Two processes build into one fresh directory at the same moment:
    both report success, the directory holds the two artifacts and no
    leftover, and the library and the binary both work."""
    build = str(tmp_path / "native")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, build], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert all(o.startswith("True") for o in outs), outs
    assert sorted(os.listdir(build)) == [".lock", native.KITTI_EVAL_NAME,
                                         native.LIB_NAME]
    rng = np.random.RandomState(10)
    pred = rng.randint(0, 8, (16, 16)).astype(np.uint8)
    cm = native.add_to_confusion_matrix(pred, pred, np.zeros((8, 8),
                                                             np.uint64),
                                        build_dir=build)
    assert cm.trace() == 256
    results = _kitti_results(3)
    DATASETS["kitti2d"]("").write_kitti_results(results, str(tmp_path / "r"))
    _kitti_gt(str(tmp_path / "gt"), results)
    assert native.run_kitti_eval(str(tmp_path / "gt"), str(tmp_path / "r"),
                                 build_dir=build) is not None
