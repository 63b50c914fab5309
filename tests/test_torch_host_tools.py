"""The port's offline tools (centerpoly_tpu_torch/tools/) against the JAX
package's, which draw with Pillow and cv2, and against cv2 itself (CPU).

Mirrors tests/test_tools.py and tests/test_analysis_tools.py:

* gt_polygons: `polygon_to_box`, `perimeter_points`, `rasterize_polygon`
  (Pillow's fill with the outline erased), `ray_cast_polygon`, the three
  `sample_polygon` methods, `generate_annotations` and `main` equal to
  JAX's;
* csv_coco and polar: `csv_to_coco` (subsampled too), `write_csv_row`,
  `cartesian_to_polar_flat`, `coco_poly_to_polar` and both `main`s equal;
* contours: `find_external_contours`, `arc_length` and `approx_poly_dp`
  give cv2's vertex lists on 240 seeded masks (smooth blobs, noise,
  nested rings, discs and strokes);
* analysis: `eval_coco_results`, `polygon_coverage`, `simplify_masks`
  (every output mask pixel-equal to JAX's), `parse_training_log`,
  `plot_training_log` (and [] without matplotlib), `merge_coco_json`
  equal to JAX's; `visualize_results`' overlay within
  tests/test_torch_debugger.py's 1 px of JAX's (labels aside: the port
  draws them in its bitmap font).
"""
import csv
import json
import math
import os
import sys

import numpy as np
import pytest
from scipy.ndimage import gaussian_filter
from scipy.spatial import cKDTree

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

cv2 = pytest.importorskip("cv2")
pytest.importorskip("PIL")

from centerpoly_tpu import tools as jtools  # noqa: E402
from centerpoly_tpu.tools import analysis as janalysis  # noqa: E402
from centerpoly_tpu.tools import csv_coco as jcsv  # noqa: E402
from centerpoly_tpu.tools import gt_polygons as jgt  # noqa: E402
from centerpoly_tpu.tools import polar as jpolar  # noqa: E402
from centerpoly_tpu_torch import tools as ttools  # noqa: E402
from centerpoly_tpu_torch.tools import analysis as tanalysis  # noqa: E402
from centerpoly_tpu_torch.tools import contours  # noqa: E402
from centerpoly_tpu_torch.tools import csv_coco as tcsv  # noqa: E402
from centerpoly_tpu_torch.tools import gt_polygons as tgt  # noqa: E402
from centerpoly_tpu_torch.tools import polar as tpolar  # noqa: E402
from centerpoly_tpu_torch.utils.png import read_frame, read_png  # noqa

from test_coco_eval import _make_gt  # noqa: E402

DIAMOND = [(64, 20), (100, 60), (64, 100), (28, 60)]


def test_exports_are_jaxs():
    names = {n for n, v in vars(jtools).items()
             if not n.startswith("_") and not isinstance(v, type(os))}
    assert names and names <= set(dir(ttools))


# -- gt_polygons --------------------------------------------------------------

def _random_polygons(seed, n=12, h=128, w=160):
    rng = np.random.RandomState(seed)
    out = [DIAMOND]
    for _ in range(n):
        k = int(rng.randint(3, 40))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(5, 50, k)
        c = rng.uniform(20, [w - 20, h - 20])
        out.append(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                            1).tolist())
    return out


def test_polygon_helpers_match_jax():
    assert tgt.polygon_to_box(DIAMOND) == jgt.polygon_to_box(DIAMOND)
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(
            tgt.perimeter_points((3.5, 7, 100.25, 41), n),
            jgt.perimeter_points((3.5, 7, 100.25, 41), n))
    with pytest.raises(AssertionError):
        tgt.perimeter_points((0, 0, 10, 10), 6)
    for poly in _random_polygons(1) + [[(-20.5, -3), (300, 40), (50, 400)]]:
        m = tgt.rasterize_polygon(poly, 128, 160)
        np.testing.assert_array_equal(m, jgt.rasterize_polygon(poly, 128, 160))
        assert m.dtype == np.uint8
    mask = tgt.rasterize_polygon(DIAMOND, 128, 128)
    rng = np.random.RandomState(2)
    starts = rng.uniform(-10, 140, (50, 2))
    targets = rng.uniform(0, 128, (50, 2))
    np.testing.assert_array_equal(
        tgt.ray_cast_polygon(mask, starts, targets),
        jgt.ray_cast_polygon(mask, starts, targets))


@pytest.mark.parametrize("method", ["regular_interval", "grid_based",
                                    "real_points"])
def test_sample_polygon_matches_jax(method):
    for poly in _random_polygons(3):
        for n in (4, 16, 32):
            np.testing.assert_array_equal(
                tgt.sample_polygon(poly, n, method, 128, 160),
                jgt.sample_polygon(poly, n, method, 128, 160))
    with pytest.raises(ValueError, match="unknown sampling"):
        tgt.sample_polygon(DIAMOND, 16, "nope")


def _cityscapes_tree(root):
    """leftImg8bit/train/<city>/*_leftImg8bit.png and the matching
    gtFine/train/<city>/*_gtFine_polygons.json (two frames)."""
    objs = [
        {"label": "car", "polygon": [[30, 40], [90, 40], [90, 90], [30, 90]]},
        {"label": "sky", "polygon": [[0, 0], [255, 0], [255, 10], [0, 10]]},
        {"label": "person", "polygon": [[150, 30], [190, 60], [150, 100],
                                        [120, 60]]},
        {"label": "rider", "polygon": _random_polygons(4, 1)[1]},
    ]
    for i in range(2):
        for kind in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, kind, "train", "aachen"),
                        exist_ok=True)
        stem = f"aachen_00000{i}_000019"
        open(os.path.join(root, "leftImg8bit", "train", "aachen",
                          f"{stem}_leftImg8bit.png"), "wb").close()
        with open(os.path.join(root, "gtFine", "train", "aachen",
                               f"{stem}_gtFine_polygons.json"), "w") as f:
            json.dump({"imgHeight": 128, "imgWidth": 256,
                       "objects": objs[:2 + 2 * i]}, f)
    return root


def test_generate_annotations_and_main_match_jax(tmp_path):
    root = _cityscapes_tree(str(tmp_path / "cs"))
    gt = os.path.join(root, "gtFine", "train", "aachen",
                      "aachen_000001_000019_gtFine_polygons.json")
    img = gt.replace("gtFine", "leftImg8bit").replace(
        "_leftImg8bit_polygons.json", "_leftImg8bit.png")
    for method in ("regular_interval", "grid_based", "real_points"):
        rows = tgt.generate_annotations(gt, img, 16, method, height=128,
                                        width=256)
        assert rows == jgt.generate_annotations(gt, img, 16, method,
                                                height=128, width=256)
    assert rows[0][5] == "rider" and rows[0][6] == 0
    assert tgt.generate_annotations(gt, img, 16, labels=["bus"]) == \
        [[os.path.abspath(img), -1, -1, -1, -1, "no_object", 0]]
    outs = []
    for mod, tag in ((tgt, "port"), (jgt, "jax")):
        out = str(tmp_path / f"{tag}.csv")
        mod.main(["--data_dir", root, "--out", out, "--nbr_points", "8"])
        outs.append(open(out).read())
    assert outs[0] == outs[1] and outs[0].count("\n") == 4


# -- csv_coco and polar -------------------------------------------------------

def test_csv_coco_and_polar_match_jax(tmp_path):
    root = _cityscapes_tree(str(tmp_path / "cs"))
    csv_path = str(tmp_path / "gt.csv")
    tgt.main(["--data_dir", root, "--out", csv_path])
    with open(csv_path, "a", newline="") as f:       # a UA-DETRAC name too
        w = csv.writer(f)
        tcsv.write_csv_row(w, "img00010.jpg", (1.5, 2, 30, 40.7), "car", 0,
                           [1.9, 2, 3, 4, 5, 6])
    jpath = str(tmp_path / "jgt.csv")
    with open(jpath, "w", newline="") as f:
        jcsv.write_csv_row(csv.writer(f), "img00010.jpg", (1.5, 2, 30, 40.7),
                           "car", 0, [1.9, 2, 3, 4, 5, 6])
    assert open(csv_path).read().endswith(open(jpath).read())
    # subsampled by 10, only img00010 stays (the Cityscapes frames are 19)
    for sub, n_anns in ((10, 1), (None, 5)):
        got = tcsv.csv_to_coco(csv_path, str(tmp_path / "t.json"),
                               subsample=sub)
        assert got == jcsv.csv_to_coco(csv_path, str(tmp_path / "j.json"),
                                       subsample=sub)
        assert json.load(open(tmp_path / "t.json")) == got
        assert len(got["annotations"]) == n_anns
    assert tcsv.CITYSCAPES_CATS == jcsv.CITYSCAPES_CATS
    assert tcsv.IDD_CATS == jcsv.IDD_CATS
    for mod, tag in ((tcsv, "t"), (jcsv, "j")):
        mod.main([csv_path, str(tmp_path / f"{tag}m.json"), "--cats", "idd"])
    assert open(tmp_path / "tm.json").read() == \
        open(tmp_path / "jm.json").read()
    for pts in ([3.0, 4.0, -3.0, 4.0, 0.0, -2.0, -1e-9, 5.0], [7.5, 1.0]):
        assert tpolar.cartesian_to_polar_flat(pts, 1.0, -2.0) == \
            jpolar.cartesian_to_polar_flat(pts, 1.0, -2.0)
    coco = str(tmp_path / "t.json")
    assert tpolar.coco_poly_to_polar(coco, str(tmp_path / "tp.json")) == \
        jpolar.coco_poly_to_polar(coco, str(tmp_path / "jp.json"))
    assert open(tmp_path / "tp.json").read() == \
        open(tmp_path / "jp.json").read()
    for mod, tag in ((tpolar, "t"), (jpolar, "j")):
        mod.main([coco, str(tmp_path / f"{tag}pm.json"),
                  "--weight_angle", "1"])
    assert open(tmp_path / "tpm.json").read() == \
        open(tmp_path / "jpm.json").read()


# -- contours against cv2 -----------------------------------------------------

def _mask(kind, rng):
    h, w = (int(v) for v in rng.randint(1, 120, 2))
    if kind == "blobs":
        m = gaussian_filter(rng.rand(h, w), rng.uniform(0.5, 4)) > \
            rng.uniform(0.45, 0.55)
    elif kind == "noise":
        m = rng.rand(h, w) > rng.uniform(0.3, 0.9)
    elif kind == "rings":               # components inside others' holes
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.randint(1, 6))):
            y0, x0 = rng.randint(-5, h), rng.randint(-5, w)
            m[max(y0, 0):y0 + rng.randint(1, 40),
              max(x0, 0):x0 + rng.randint(1, 40)] ^= True
    else:                               # discs and strokes
        m = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.randint(1, 5))):
            cv2.circle(m, (int(rng.randint(0, w)), int(rng.randint(0, h))),
                       int(rng.randint(0, 30)), 255,
                       -1 if rng.rand() < 0.7 else int(rng.randint(1, 4)))
    return (np.asarray(m, bool) * rng.randint(1, 256)).astype(np.uint8)


@pytest.mark.parametrize("kind", ["blobs", "noise", "rings", "discs"])
def test_contours_are_cv2s(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    n_contours = 0
    for case in range(60):
        img = _mask(kind, rng)
        ref, _ = cv2.findContours(img.copy(), cv2.RETR_EXTERNAL,
                                  cv2.CHAIN_APPROX_SIMPLE)
        got = contours.find_external_contours(img)
        assert len(got) == len(ref), (kind, case)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.int32
            length = cv2.arcLength(b, True)
            assert contours.arc_length(a, True) == length
            assert contours.arc_length(a, False) == cv2.arcLength(b, False)
            for alpha in (0.001, 0.01, 0.05, 0.2):
                np.testing.assert_array_equal(
                    contours.approx_poly_dp(a, alpha * length),
                    cv2.approxPolyDP(b, alpha * length, True))
        n_contours += len(ref)
    assert n_contours > 60


# -- analysis -----------------------------------------------------------------

def test_eval_coco_results_matches_jax(tmp_path):
    gt = _make_gt(tmp_path)
    data = json.load(open(gt))
    rng = np.random.RandomState(0)
    rows = [{"image_id": a["image_id"], "category_id": a["category_id"],
             "bbox": (np.asarray(a["bbox"]) + rng.uniform(-4, 4, 4)).tolist(),
             "score": float(rng.rand())} for a in data["annotations"]]
    rj = tmp_path / "res.json"
    json.dump(rows, open(rj, "w"))
    got = tanalysis.eval_coco_results(gt, str(rj))
    assert got == janalysis.eval_coco_results(gt, str(rj))
    assert 0 < got["AP"] < 1


def test_polygon_coverage_matches_jax(tmp_path):
    images, anns = [], []
    for i, poly in enumerate(_random_polygons(6, 5)):
        images.append({"id": i, "file_name": f"{i}.png", "height": 128,
                       "width": 160})
        flat = np.asarray(poly, np.float64).reshape(-1).tolist()
        anns.append({"id": i, "image_id": i, "category_id": 1,
                     "bbox": [0, 0, 1, 1], "segmentation": [flat]})
    path = tmp_path / "gt.json"
    json.dump({"images": images, "annotations": anns,
               "categories": [{"id": 1, "name": "a"}]}, open(path, "w"))
    for method in ("regular_interval", "grid_based"):
        got = tanalysis.polygon_coverage(str(path), 16, method)
        assert got == janalysis.polygon_coverage(str(path), 16, method)
        assert got["n"] == 6 and got["mean_iou"] > 0.5


def test_simplify_masks_matches_jax(tmp_path):
    """Seeded blob masks (several components, holes, shapes touching the
    border): every output mask pixel-equal to JAX's (cv2 contours, Pillow
    fill), and the polygons' vertex lists cv2's."""
    src = tmp_path / "masks"
    src.mkdir()
    rng = np.random.RandomState(9)
    for i in range(8):
        m = (gaussian_filter(rng.rand(96, 128), 3 + i % 3) > 0.5)
        cv2.imwrite(str(src / f"m{i}.png"), m.astype(np.uint8) * 255)
    m = np.zeros((64, 64), np.uint8)
    cv2.circle(m, (32, 32), 20, 255, -1)
    cv2.imwrite(str(src / "circle.png"), m)
    (src / "notes.txt").write_text("not a mask")
    for alpha in (0.001, 0.02):
        tanalysis.simplify_masks(str(src), str(tmp_path / "t"), alpha)
        janalysis.simplify_masks(str(src), str(tmp_path / "j"), alpha)
        names = sorted(os.listdir(tmp_path / "t"))
        assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 9
        for name in names:
            np.testing.assert_array_equal(
                read_png(str(tmp_path / "t" / name)),
                cv2.imread(str(tmp_path / "j" / name), cv2.IMREAD_GRAYSCALE),
                err_msg=f"{alpha} {name}")
        if alpha == 0.001:              # tests/test_analysis_tools.py's bar
            out = read_png(str(tmp_path / "t" / "circle.png"))
            assert np.logical_and(out > 0, m > 0).sum() / \
                np.logical_or(out > 0, m > 0).sum() > 0.9


def test_visualize_results_within_a_pixel_of_jax(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    frame = np.random.RandomState(0).randint(0, 60, (96, 128, 3), np.uint8)
    cv2.imwrite(str(img_dir / "0.png"), frame)
    rows = [{"image_id": 0, "category_id": 3, "score": 0.9,
             "polygon": [20, 30, 70, 28, 90, 80, 25, 70], "depth": 1.0},
            {"image_id": 0, "category_id": 5, "score": 0.1,
             "polygon": [5, 5, 9, 5, 9, 9], "depth": 2.0},
            {"image_id": 7, "category_id": 1, "score": 0.9,
             "polygon": [1, 1, 5, 1, 5, 5], "depth": 1.0}]
    rj = tmp_path / "res.json"
    json.dump(rows, open(rj, "w"))
    got = tanalysis.visualize_results(str(rj), str(img_dir),
                                      str(tmp_path / "t"))
    want = janalysis.visualize_results(str(rj), str(img_dir),
                                       str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["0.png"]
    a, b = read_frame(got[0]), cv2.imread(want[0])
    assert a.shape == b.shape == frame.shape
    color = tanalysis_color(3)
    # the outline below the label's baseline (y >= 28 - 1), in the
    # class colour; the frame's noise stays under 60 in every channel
    pa = np.argwhere((a == color).all(-1)[27:]) + [27, 0]
    pb = np.argwhere((b == color).all(-1)[27:]) + [27, 0]
    assert len(pa) > 100 and len(pb) > 100
    d = max(cKDTree(pb).query(pa)[0].max(), cKDTree(pa).query(pb)[0].max())
    assert d <= 1.0, d
    # the label is drawn above the polygon, the dropped row nowhere
    assert (a[:27] != frame[:27]).any()
    np.testing.assert_array_equal(a[:4, :12], frame[:4, :12])


def tanalysis_color(cat):
    from centerpoly_tpu_torch.utils.debugger import Debugger
    return Debugger(num_classes=32).colors[cat]


LOG = ("2026-08-18-21-00: model dla_34: 18.54M parameters\n"
       "2026-08-18-21-01: epoch 1 | 10 iters | 5.0s | "
       "loss 10.5000 hm_loss 4.2000 poly_loss 6.3000\n"
       "2026-08-18-21-02: val   1 | loss 11.0000 hm_loss 4.5000\n"
       "2026-08-18-21-03: epoch 2 | 10 iters | 4.0s | "
       "loss 9.0000 hm_loss 3.9000 poly_loss 5.1000 bad x\n"
       "2026-08-18-21-04: val   2 | AP eval skipped: no gt\n"
       "epoch x | nothing\n")


def test_training_log_parse_and_plot_match_jax(tmp_path, monkeypatch):
    log = tmp_path / "log.txt"
    log.write_text(LOG)
    got = tanalysis.parse_training_log(str(log))
    assert got == janalysis.parse_training_log(str(log))
    assert [v for _, v in got[0]["loss"]] == [10.5, 9.0]
    for mod, tag in ((tanalysis, "t"), (janalysis, "j")):
        written = mod.plot_training_log(str(log), str(tmp_path / tag))
        assert [os.path.basename(w) for w in written] == \
            [f"{tag}_train.png", f"{tag}_valid.png"]
        assert all(os.path.exists(w) for w in written)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tanalysis.plot_training_log(str(log), str(tmp_path / "x")) == []


def test_merge_coco_json_matches_jax(tmp_path):
    a = {"images": [{"id": 1, "file_name": "a.png"}], "type": "instances",
         "annotations": [{"id": 10, "image_id": 1}],
         "categories": [{"id": 1, "name": "car"}]}
    b = {"images": [{"id": 1, "file_name": "b.png"},
                    {"id": 4, "file_name": "c.png"}],
         "annotations": [{"id": 9, "image_id": 4}, {"id": 11, "image_id": 1}]}
    paths = []
    for name, d in (("a", a), ("b", b)):
        paths.append(str(tmp_path / f"{name}.json"))
        json.dump(d, open(paths[-1], "w"))
    got = tanalysis.merge_coco_json(paths, str(tmp_path / "t.json"))
    assert got == janalysis.merge_coco_json(paths, str(tmp_path / "j.json"))
    assert got == {"images": 3, "annotations": 3}
    assert json.load(open(tmp_path / "t.json")) == \
        json.load(open(tmp_path / "j.json"))


def test_real_points_keeps_the_reference_anchor():
    """real_points rotates to start nearest (x0, x1): the reference's
    bbox[0], bbox[2], kept as in JAX."""
    hexagon = [(50 + 30 * math.cos(a), 50 + 30 * math.sin(a))
               for a in np.linspace(0, 2 * math.pi, 7)[:-1]]
    for n in (4, 8, 12):
        pts = tgt.sample_polygon(hexagon, n, "real_points")
        assert pts.shape == (n, 2)
        np.testing.assert_array_equal(
            pts, jgt.sample_polygon(hexagon, n, "real_points"))
