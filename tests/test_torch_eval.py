"""The port's eval host code against the JAX package's (which draws and
reads with Pillow) and against Pillow and cv2 themselves: the PNG codec
(centerpoly_tpu_torch/utils/png.py), the rasterizer (masks and manifests
byte for byte) and the instance-AP evaluator (dicts equal, NaN for NaN).
Small shapes, seeded with numpy."""
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.data.datasets import CityscapesMeta as JCityscapes
from centerpoly_tpu.eval import harness as jharness
from centerpoly_tpu.eval import instance_eval as jeval
from centerpoly_tpu.eval import rasterize as jrast
from centerpoly_tpu_torch.data.datasets import CityscapesMeta
from centerpoly_tpu_torch.eval import harness, instance_eval, rasterize
from centerpoly_tpu_torch.utils import png

H, W = 128, 256


# -- the PNG codec ----------------------------------------------------------

def _smooth(rng, shape):
    """Gradients plus a little noise, so encoders pick varied row filters."""
    h, w = shape[:2]
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 256
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 40
    return ((base + rng.randint(0, 9, shape)) % 256).astype(np.uint8)


def _filter_types(path):
    with open(path, "rb") as f:
        buf = f.read()
    pos, idat, hdr = 8, b"", None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        hdr = struct.unpack(">IIBBBBB", data) if kind == b"IHDR" else hdr
        idat += data if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    bpp = {0: 1, 2: 3, 6: 4}[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, w * bpp + 1)[:, 0].tolist())


@pytest.mark.parametrize("mode", ["L", "I;16", "RGB", "RGBA"])
def test_png_reads_what_pil_and_cv2_read(tmp_path, mode):
    """Files Pillow and cv2 wrote (adaptive row filters) decode to what
    np.array(Image.open) and cv2.imread give."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    shape = {"L": (37, 53), "I;16": (37, 53), "RGB": (37, 53, 3),
             "RGBA": (37, 53, 4)}[mode]
    a = _smooth(rng, shape)
    if mode == "I;16":
        a = a.astype(np.uint16) * 257 + rng.randint(0, 3, shape).astype(
            np.uint16)
    pil_path = str(tmp_path / "pil.png")
    Image.fromarray(a).save(pil_path)
    cv_path = str(tmp_path / "cv2.png")
    cv_arr = a if a.ndim == 2 else a[..., [2, 1, 0, 3][:a.shape[2]]]
    assert cv2.imwrite(cv_path, cv_arr)
    filters = set()
    for path in (pil_path, cv_path):
        filters |= _filter_types(path)
        got = png.read_png(path)
        want = np.array(Image.open(path))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(png.read_frame(path), cv2.imread(path))
    assert len(filters) > 1, filters


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_row_filters(tmp_path, kind):
    """Each of the five row filters, on every row, in 8-bit gray, 16-bit
    gray and RGB, and at widths 1 and 2: Pillow reads the files as the
    source array, and so does the port."""
    rng = np.random.RandomState(kind)
    arrays = [rng.randint(0, 256, (17, 23), dtype=np.uint8),
              rng.randint(0, 65536, (9, 6)).astype(np.uint16),
              _smooth(rng, (13, 29, 3)),
              rng.randint(0, 256, (7, 1), dtype=np.uint8),
              rng.randint(0, 256, (5, 2, 3), dtype=np.uint8)]
    for a in arrays:
        buf = png.encode_png(a, filter=kind)
        assert _filter_types_bytes(buf, tmp_path) == {kind}
        np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(buf))), a)
        np.testing.assert_array_equal(png.decode_png(buf), a)


def _filter_types_bytes(buf, tmp_path):
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(buf)
    return _filter_types(path)


def test_png_mixed_row_filters_take_the_diagonal_path():
    """A different filter on each row (Average and Paeth among None, Sub
    and Up), RGB: the rows from the first Average/Paeth row on are undone
    along anti-diagonals; Pillow agrees."""
    rng = np.random.RandomState(3)
    a = _smooth(rng, (31, 47, 3))
    kinds = rng.randint(0, 5, 31)
    kinds[:3] = (1, 2, 0)                 # the row-at-a-time path first
    rows = a.reshape(31, -1)
    filtered = np.stack([png._filter_rows(rows, int(k), 3)[r]
                         for r, k in enumerate(kinds)])
    raw = np.concatenate([kinds[:, None].astype(np.uint8), filtered], 1)
    ihdr = struct.pack(">IIBBBBB", 47, 31, 8, 2, 0, 0, 0)
    buf = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
           + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
           + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(buf))), a)
    np.testing.assert_array_equal(png.decode_png(buf), a)


def test_png_writes_what_pil_and_cv2_read(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(1)
    for a in (rng.randint(0, 256, (11, 13), dtype=np.uint8),
              rng.randint(0, 65536, (11, 13)).astype(np.uint16),
              rng.randint(0, 256, (11, 13, 3), dtype=np.uint8)):
        path = str(tmp_path / "a.png")
        png.write_png(path, a)
        np.testing.assert_array_equal(np.array(Image.open(path)), a)
    bgr = rng.randint(0, 256, (11, 13, 3), dtype=np.uint8)
    png.write_frame(path, bgr)
    np.testing.assert_array_equal(cv2.imread(path), bgr)
    np.testing.assert_array_equal(png.read_frame(path), bgr)
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))


def _with_ihdr_byte(buf, index, value):
    """`buf` with IHDR data byte `index` set to `value`, CRC redone."""
    data = bytearray(buf[16:29])
    data[index] = value
    return (buf[:16] + bytes(data)
            + struct.pack(">I", zlib.crc32(b"IHDR" + bytes(data))) + buf[33:])


@pytest.mark.parametrize("case", ["palette", "gray_alpha", "one_bit",
                                  "rgb16", "interlaced", "crc", "signature"])
def test_png_rejects_what_it_cannot_decode(case):
    rng = np.random.RandomState(2)
    a = rng.randint(0, 256, (6, 7), dtype=np.uint8)
    out = io.BytesIO()
    if case == "palette":
        Image.fromarray(a).convert("P").save(out, "PNG")
    elif case == "gray_alpha":
        Image.fromarray(a).convert("LA").save(out, "PNG")
    elif case == "one_bit":
        Image.fromarray(a).convert("1").save(out, "PNG")
    else:
        out.write(png.encode_png(a))
    buf = out.getvalue()
    if case == "rgb16":      # colour type 2 at bit depth 16
        buf = _with_ihdr_byte(_with_ihdr_byte(buf, 8, 16), 9, 2)
    elif case == "interlaced":
        buf = _with_ihdr_byte(buf, 12, 1)
    elif case == "crc":
        buf = buf[:-5] + bytes([buf[-5] ^ 1]) + buf[-4:]
    elif case == "signature":
        buf = b"\x89PNX" + buf[4:]
    with pytest.raises(ValueError):
        png.decode_png(buf)


# -- the rasterizer ---------------------------------------------------------

def _polygons(rng):
    """Seeded polygon sets at H x W: convex, self-crossing (a pentagram),
    random crossing, degenerate (one point, a line), out of the frame,
    thousands of pixels off it, and a 16-vertex box on the frame's edge."""
    polys = []
    ang = np.linspace(0, 2 * np.pi, 6)[:-1]
    star = [(int(120 + 40 * np.cos(t)), int(64 + 40 * np.sin(t)))
            for t in ang[[0, 2, 4, 1, 3]]]
    polys.append(star)
    for _ in range(12):
        n = rng.choice([3, 5, 16])
        t = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(3, 50, n)
        c = rng.uniform(0, [W, H])
        polys.append(list(zip((c[0] + r * np.cos(t)).astype(int).tolist(),
                              (c[1] + r * np.sin(t)).astype(int).tolist())))
    for _ in range(12):
        pts = rng.uniform([-30, -30], [W + 30, H + 30], (rng.choice([4, 16]),
                                                          2))
        polys.append([(int(x), int(y)) for x, y in pts])
    polys += [[(50, 50)] * 16, [(10, 10), (60, 10), (10, 10)],
              [(-5000, -3000), (4000, 90), (100, 7000), (-40, 60)],
              [(-100, -100), (-50, -100), (-50, -60)],
              [(0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)],
              [(int(-0.7), 5), (30, int(-0.9)), (int(20.99), 40)]]
    return polys


def test_bresenham_matches_jax():
    rng = np.random.RandomState(0)
    segs = [rng.randint(-9, 9, 4) for _ in range(300)]
    segs += [rng.randint(-400, 400, 4) for _ in range(300)]
    segs += [np.array([3, 3, 3, 3]), np.array([0, 0, 0, 9]),
             np.array([0, 9, 0, 0]), np.array([7, 0, -7, 0]),
             np.array([0, 0, 5, 5]), np.array([5, 5, 0, 0]),
             np.array([-6000, -20, 6000, 30])]
    for s in segs:
        assert rasterize.bresenham_line(*s.tolist()) == \
            jrast.bresenham_line(*s.tolist()), s


def test_render_instance_mask_matches_jax():
    rng = np.random.RandomState(1)
    for pts in _polygons(rng):
        got = rasterize.render_instance_mask(pts, (W, H))
        want = np.array(jrast.render_instance_mask(pts, (W, H)))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(pts))


def test_fill_is_even_odd_and_edges_lie_in_the_disks():
    """The pentagram's centre stays empty (even-odd, Pillow's rule); and on
    random self-crossing polygons, every pixel where Pillow's bare fill
    and the port's bare fill differ lies within a contour disk."""
    ang = np.linspace(0, 2 * np.pi, 6)[:-1]
    star = [(int(120 + 40 * np.cos(t)), int(64 + 40 * np.sin(t)))
            for t in ang[[0, 2, 4, 1, 3]]]
    mask = rasterize.render_instance_mask(star, (W, H))
    assert mask[64, 120] == 0 and mask[64, 150] == 255
    rng = np.random.RandomState(2)
    differ = 0
    for pts in _polygons(rng):
        im = Image.new("L", (W, H), 0)
        from PIL import ImageDraw
        ImageDraw.Draw(im).polygon(pts, outline=255, fill=255)
        pil = np.array(im) > 0
        pts_a = np.asarray(pts)
        ours = rasterize._fill_even_odd(pts_a[:, 0], pts_a[:, 1], (0, H, 0, W))
        drawn = rasterize.render_instance_mask(pts, (W, H)) > 0
        assert np.all(drawn[pil != ours]), pts
        differ += int((pil != ours).sum())
    assert differ > 0       # the tie rules do differ; the disks cover them


class _TinyMeta:
    """The Cityscapes class tables at H x W (both packages' rasterizers
    read only these attributes)."""
    eval_image_size = (H, W)
    class_name = CityscapesMeta.class_name
    label_to_id = CityscapesMeta.label_to_id
    eval_drop_classes = CityscapesMeta.eval_drop_classes


def _results(rng, n_images=3):
    """{img_id: {class: rows}}: scores either side of 0.5 and of 1/1.2 and
    below the threshold, tied depths, a drop class (9, pole), an empty
    class and the 'fg' key."""
    results = {}
    polys = _polygons(rng)
    scores = [0.04, 0.3, 0.49999, 0.5, 0.7, 1 / 1.2, 0.84, 0.95]
    for i in range(n_images):
        per = {"fg": np.zeros((1, 38), np.float32), 2: np.zeros((0, 38))}
        for cls in (1, 3, 9):
            rows = []
            for k in range(6):
                pts = polys[rng.randint(len(polys))]
                pts = (pts * 16)[:16]
                poly = np.asarray(pts, np.float32).reshape(-1)
                poly = poly + rng.uniform(0, 0.99, poly.shape)
                box = [poly[0::2].min(), poly[1::2].min(), poly[0::2].max(),
                       poly[1::2].max()]
                depth = float(rng.choice([0.0, 1.0, 2.5]))
                rows.append(np.concatenate([box, [scores[(k + i + cls) % 8]],
                                            poly, [depth]]))
            per[cls] = np.asarray(rows, np.float32)
        results[i] = per
    return results


def test_rasterize_results_matches_jax_byte_for_byte(tmp_path):
    rng = np.random.RandomState(3)
    results = _results(rng)
    id_to_file = {i: f"city/city_{i:06d}_000019_leftImg8bit.png"
                  for i in results}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jrast.rasterize_results(results, _TinyMeta, jdir, id_to_file)
    rasterize.rasterize_results(results, _TinyMeta, pdir, id_to_file)
    txts = sorted(f for f in os.listdir(jdir) if f.endswith(".txt"))
    assert txts == sorted(f for f in os.listdir(pdir) if f.endswith(".txt"))
    masks = sorted(os.listdir(os.path.join(jdir, "masks")))
    assert masks == sorted(os.listdir(os.path.join(pdir, "masks")))
    assert len(masks) > 10
    for t in txts:
        with open(os.path.join(jdir, t), "rb") as a, \
                open(os.path.join(pdir, t), "rb") as b:
            assert a.read() == b.read(), t
    for m in masks:
        want = np.array(Image.open(os.path.join(jdir, "masks", m)))
        got = np.array(Image.open(os.path.join(pdir, "masks", m)))
        np.testing.assert_array_equal(got, want, err_msg=m)
        np.testing.assert_array_equal(
            png.read_mask(os.path.join(jdir, "masks", m)), want)
    lines = [ln for t in txts for ln in open(os.path.join(pdir, t))]
    assert any(ln.split()[2] == "1" for ln in lines)      # min(1, s*1.2)


# -- the evaluator ----------------------------------------------------------

def _eval_case(rng, n_images=3):
    """GT instance images with real instances, a group region (bare label
    id), void pixels, regions under 100 px; predictions overlapping them,
    duplicates of one instance, void hits and empty masks.  The
    label table has classes that never occur (all-NaN)."""
    gts, preds = {}, {}
    for i in range(n_images):
        gt = np.zeros((H, W), np.int32)
        gt[:20, :] = 3                             # void (ignoreInEval)
        gt[30:70, 10:60] = 26000 + 0
        gt[40:90, 80:150] = 26000 + 1
        gt[100:108, 200:210] = 26000 + 2          # 80 px: under 100
        gt[90:120, 160:200] = 26                   # group region
        gt[60:100, 200:250] = 24000 + i            # person
        key = f"img{i}"
        gts[key] = gt
        p = []
        for k in range(7):
            m = np.zeros((H, W), np.uint8)
            y0, x0 = rng.randint(0, H - 30), rng.randint(0, W - 40)
            m[y0:y0 + rng.randint(8, 50), x0:x0 + rng.randint(8, 70)] = 255
            p.append({"mask": m, "labelID": int(rng.choice([24, 26, 33])),
                      "conf": float(rng.rand())})
        dup = np.zeros((H, W), np.uint8)
        dup[32:70, 12:60] = 255
        p += [{"mask": dup, "labelID": 26, "conf": 0.9},
              {"mask": dup.copy(), "labelID": 26, "conf": 0.6},
              {"mask": np.zeros((H, W), np.uint8), "labelID": 26,
               "conf": 0.5},
              {"mask": dup, "labelID": 7, "conf": 0.5}]
        preds[key] = p
    return gts, preds


def _same(a, b):
    """Dicts equal, NaN for NaN (json spells NaN alike)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("workers", [0, 2])
def test_evaluate_instances_matches_jax(workers):
    gts, preds = _eval_case(np.random.RandomState(4))
    got = instance_eval.evaluate_instances(gts, preds, workers=workers)
    want = jeval.evaluate_instances(gts, preds, workers=0)
    assert _same(got, want), (got, want)
    assert np.isnan(got["classes"]["train"]["ap"])
    assert 0 < got["allAp"] < 1


def test_match_and_ap_pieces_match_jax():
    gts, preds = _eval_case(np.random.RandomState(5), n_images=1)
    cfg = instance_eval.InstanceEvalConfig()
    jcfg = jeval.InstanceEvalConfig()
    for key in gts:
        assert _same(instance_eval.match_image(gts[key], preds[key], cfg),
                     jeval.match_image(gts[key], preds[key], jcfg))
        assert _same(instance_eval.gt_instances_from_image(gts[key], cfg),
                     jeval.gt_instances_from_image(gts[key], jcfg))
    rng = np.random.RandomState(6)
    for _ in range(20):
        n = rng.randint(1, 12)
        y_true = rng.randint(0, 2, n).astype(float)
        y_score = rng.choice([0.1, 0.5, 0.7, 0.9], n)
        assert instance_eval._average_precision(y_true, y_score, 3) == \
            jeval._average_precision(y_true, y_score, 3)


def test_load_prediction_dir_reads_what_the_jax_harness_wrote(tmp_path):
    """Masks Pillow wrote (the JAX rasterizer) read back through png.py as
    the JAX reader reads them; the AP on them agrees."""
    rng = np.random.RandomState(7)
    results = _results(rng, n_images=2)
    id_to_file = {i: f"{i}.png" for i in results}
    res_dir = str(tmp_path / "res")
    jrast.rasterize_results(results, _TinyMeta, res_dir, id_to_file)
    keys = [str(i) for i in results] + ["missing"]
    got = instance_eval.load_prediction_dir(res_dir, keys)
    want = jeval.load_prediction_dir(res_dir, keys)
    assert got.keys() == want.keys() and got["missing"] == []
    n = 0
    for k in keys:
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            assert g["labelID"] == w["labelID"] and g["conf"] == w["conf"]
            np.testing.assert_array_equal(g["mask"], w["mask"])
            n += 1
    assert n > 4


def test_run_instance_eval_matches_jax_on_gt_pngs(tmp_path):
    """The harness end to end from 16-bit GT PNGs Pillow wrote under
    gtFine/, found by the frames' Cityscapes names: instance_ap.json,
    gtInstances.json and results.json equal to the JAX harness's."""
    rng = np.random.RandomState(8)
    results = _results(rng, n_images=2)
    gts, _ = _eval_case(rng, n_images=2)

    class Ann:
        imgs = {i: {"file_name": f"c/c_{i:06d}_000019_leftImg8bit.png"}
                for i in results}

    gt_dir = tmp_path / "gtFine" / "val" / "c"
    gt_dir.mkdir(parents=True)
    for i, gt in zip(results, gts.values()):
        gt = np.where(gt == 3, 0, gt)
        Image.fromarray(gt.astype(np.uint16)).save(
            str(gt_dir / f"c_{i:06d}_000019_gtFine_instanceIds.png"))
    out = {}
    for name, fn in (("jax", jharness.run_instance_eval),
                     ("port", harness.run_instance_eval)):
        d = str(tmp_path / name)
        res = fn(_TinyMeta, results, d, annotations=Ann,
                 gt_instance_dir=str(tmp_path / "gtFine" / "val"))
        assert res is not None
        out[name] = {f: open(os.path.join(d, f)).read() for f in
                     ("instance_ap.json", "gtInstances.json",
                      "results.json")}
    assert out["port"] == out["jax"]
    assert harness.run_instance_eval(
        _TinyMeta, results, str(tmp_path / "none"), annotations=Ann,
        gt_instance_dir=str(tmp_path / "nowhere")) is None


def test_dataset_meta_tables_match_jax():
    from centerpoly_tpu.data.datasets import DATASETS as JDATASETS
    from centerpoly_tpu_torch.data.datasets import DATASETS
    assert set(DATASETS) <= set(JDATASETS) and {"kitti_poly", "IDD",
                                               "idd"} <= set(DATASETS)
    for k, cls in DATASETS.items():
        j = JDATASETS[k]
        for f in ("name", "num_classes", "class_name", "label_to_id",
                  "class_frequencies", "eval_image_size", "eval_drop_classes",
                  "instance_labels", "void_ids"):
            assert getattr(cls, f) == getattr(j, f), (k, f)
        assert cls("r").annot_path("val") == j("r").annot_path("val")
    assert JCityscapes("r").gt_instance_dir() is None
    assert CityscapesMeta("r").gt_instance_dir() is None
