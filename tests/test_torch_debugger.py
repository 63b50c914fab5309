"""The port's debug views (utils/debugger.py, infer/detector.py
`_debug_views`) against the JAX package's, which draws with cv2.

* `gen_colormap` and `add_blend_img` equal JAX's Debugger within 1 uint8
  level (cv2.resize blends in 11-bit fixed point, the port in float);
* the numpy line, polyline, rectangle and circle paint within 1 px of
  cv2's: the Hausdorff distance between the two sets of painted pixels is
  at most 1 px both ways, for shapes inside the image (where a shape
  crosses the border, cv2 clamps its spans onto the edge column);
* `debug=4` on res_18 at 64x64 with the same weights in both packages:
  `pred_hm.png` within 2 levels of JAX's, and `detections.png` written.
"""
import sys

import numpy as np
import pytest
from scipy.spatial import cKDTree

from torch_port_common import HEADS, jax_variables

cv2 = pytest.importorskip("cv2")

from centerpoly_tpu.configs import Config as JaxConfig  # noqa: E402
from centerpoly_tpu.infer import detector as jdet  # noqa: E402
from centerpoly_tpu.utils import debugger as jdbg  # noqa: E402
from centerpoly_tpu_torch.configs import Config  # noqa: E402
from centerpoly_tpu_torch.infer.detector import create_detector  # noqa: E402
from centerpoly_tpu_torch.utils import debugger as tdbg  # noqa: E402
from centerpoly_tpu_torch.utils import font  # noqa: E402
from centerpoly_tpu_torch.utils.png import read_frame  # noqa: E402


@pytest.mark.parametrize("shape,theme", [((16, 32, 8), "black"),
                                         ((13, 21, 3), "black"),
                                         ((16, 32, 8), "white")])
def test_colormap_and_blend_match_jax(shape, theme):
    rng = np.random.RandomState(3)
    hm = rng.rand(*shape).astype(np.float32) ** 4
    back = rng.randint(0, 256, (shape[0] * 4, shape[1] * 4, 3),
                       dtype=np.uint8)
    ref, got = jdbg.Debugger(8, theme=theme), tdbg.Debugger(8, theme=theme)
    cm_ref, cm_got = ref.gen_colormap(hm), got.gen_colormap(hm)
    assert cm_got.shape == cm_ref.shape == (*back.shape[:2], 3)
    assert np.abs(cm_got.astype(int) - cm_ref).max() <= 1
    # a colour map of another size goes through the resize in the blend
    small = cm_ref[::3, ::2]
    for r in (ref, got):
        r.add_blend_img(back, cm_ref, "pred_hm")
        r.add_blend_img(back, small, "small")
    for key in ("pred_hm", "small"):
        assert got.imgs[key].dtype == np.uint8
        assert np.abs(got.imgs[key].astype(int) - ref.imgs[key]).max() <= 1
    mask = rng.rand(*back.shape[:2]).astype(np.float32)
    ref.add_mask(mask, back, "mask")
    got.add_mask(mask, back, "mask")
    np.testing.assert_array_equal(got.imgs["mask"], ref.imgs["mask"])


def _hausdorff(a: np.ndarray, b: np.ndarray) -> float:
    pa, pb = np.argwhere(a.any(-1)), np.argwhere(b.any(-1))
    assert len(pa) and len(pb), (len(pa), len(pb))
    return max(cKDTree(pb).query(pa)[0].max(),
               cKDTree(pa).query(pb)[0].max())


def _shapes(kind, rng, h, w):
    """(cv2 call, port call) drawing one random shape of `kind` inside an
    (h, w) image."""
    pts = np.stack([rng.randint(3, w - 3, 6), rng.randint(3, h - 3, 6)],
                   1).astype(np.int32)
    p, q = tuple(map(int, pts[0])), tuple(map(int, pts[1]))
    r = int(rng.randint(1, 20))
    c = (int(rng.randint(r + 3, w - r - 3)), int(rng.randint(r + 3, h - r - 3)))
    col = (255, 255, 255)
    return {
        "polyline2": (lambda a: cv2.polylines(a, [pts], True, col, 2),
                      lambda b: tdbg.draw_polyline(b, pts, col, 2)),
        "line1": (lambda a: cv2.line(a, p, q, col, 1),
                  lambda b: tdbg.draw_line(b, p, q, col, 1)),
        "line2": (lambda a: cv2.line(a, p, q, col, 2),
                  lambda b: tdbg.draw_line(b, p, q, col, 2)),
        "rectangle2": (lambda a: cv2.rectangle(a, p, q, col, 2),
                       lambda b: tdbg.draw_rectangle(b, p, q, col, 2)),
        "rectangle_filled": (lambda a: cv2.rectangle(a, p, q, col, -1),
                             lambda b: tdbg.draw_rectangle(b, p, q, col, -1)),
        "circle1": (lambda a: cv2.circle(a, c, r, col, 1),
                    lambda b: tdbg.draw_circle(b, c, r, col, 1)),
        "circle_filled": (lambda a: cv2.circle(a, c, r, col, -1),
                          lambda b: tdbg.draw_circle(b, c, r, col, -1)),
    }[kind]


@pytest.mark.parametrize("kind", ["polyline2", "line1", "line2", "rectangle2",
                                  "rectangle_filled", "circle1",
                                  "circle_filled"])
def test_primitives_within_one_pixel_of_cv2(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    worst = 0.0
    for _ in range(60):
        ref_draw, port_draw = _shapes(kind, rng, 100, 120)
        a = np.zeros((100, 120, 3), np.uint8)
        b = a.copy()
        ref_draw(a)
        port_draw(b)
        worst = max(worst, _hausdorff(a, b))
    assert worst <= 1.0, worst


def test_primitives_clip_at_the_border():
    """Shapes partly or wholly outside the image paint only inside it."""
    img = np.zeros((40, 50, 3), np.uint8)
    tdbg.draw_rectangle(img, (-30, -20), (-3, -1), (9, 9, 9), -1)
    tdbg.draw_line(img, (-1000, 20), (-10, 20), (9, 9, 9), 2)
    assert not img.any()
    tdbg.draw_polyline(img, [(-1e6, -5), (25, 20), (1e6, 39)], (9, 9, 9), 2)
    tdbg.draw_circle(img, (49, 39), 5, (9, 9, 9), -1)
    tdbg.put_text(img, "edge", (45, 3), (9, 9, 9))
    assert img.any() and img.shape == (40, 50, 3)


def test_labels_and_views(tmp_path, monkeypatch):
    """Every Debugger method draws; labels use the port's bitmap font
    (printable ASCII, '?' for the rest); views are written as PNG, and
    only `show_all_imgs` needs cv2."""
    assert font.glyph("A").shape == (font.HEIGHT, font.WIDTH)
    assert (font.glyph("\x01") == font.glyph("?")).all()
    assert tdbg.text_size("car0.9") == (6 * font.ADVANCE - 1, font.HEIGHT)
    dbg = tdbg.Debugger(num_classes=8,
                        class_names=[str(i) for i in range(8)])
    img = np.zeros((64, 128, 3), np.uint8)
    hm = np.zeros((16, 32, 8), np.float32)
    hm[8, 16, 2] = 1.0
    dbg.add_blend_img(img, dbg.gen_colormap(hm), "pred_hm")
    dbg.add_img(img, "out")
    dbg.add_coco_bbox([10, 20, 60, 40], 2, 0.8, img_id="out")
    # the label's background in the class colour, its text in black
    assert (dbg.imgs["out"][12, 11] == dbg.colors[2]).all()
    dbg.add_polydet([20, 20, 40, 20, 40, 40, 20, 40], 1, 0.9, img_id="out")
    dbg.add_coco_hp(np.random.RandomState(0).randint(0, 60, (17, 2)),
                    img_id="out")
    dbg.add_points([[5, 5], [100, 50]], img_id="out")
    dbg.save_all_imgs(str(tmp_path), prefix="t_")
    dbg.save_img("out", str(tmp_path / "one"))
    for name in ("t_out.png", "t_pred_hm.png", "one/out.png"):
        np.testing.assert_array_equal(
            read_frame(str(tmp_path / name)),
            dbg.imgs[name.split("/")[-1][:-4].replace("t_", "", 1)])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        dbg.show_all_imgs()


def test_debug_polydet_batch():
    dbg = tdbg.Debugger(num_classes=2)
    img = np.zeros((64, 128, 3), np.uint8)
    hm = np.zeros((16, 32, 2), np.float32)
    hm[8, 16, 0] = 1.0
    # class 1: class 0's colour is black
    dets = np.array([[10, 10, 20, 20, 0.9, 1,
                      3, 3, 5, 3, 5, 5, 3, 5, 1.0]])
    tdbg.debug_polydet_batch(dbg, img, hm, hm, dets, gt_dets=dets)
    assert {"pred_hm", "gt_hm", "out_pred", "out_gt"} <= set(dbg.imgs)
    assert dbg.imgs["out_pred"].any() and dbg.imgs["out_gt"].any()


def test_debug_level_4_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    variables = jax_variables("res_18", HEADS, 64, 64, 64, seed=5)[1]
    frame = np.random.RandomState(0).randint(0, 256, (64, 64, 3),
                                             dtype=np.uint8)
    kw = dict(task="polydet", dataset="cityscapes", arch="res_18",
              input_h=64, input_w=64, K=8, debug=4, vis_thresh=0.0,
              mixed_precision=False)
    jdet.create_detector(JaxConfig(debug_dir=str(tmp_path / "jax"), **kw),
                         variables).run(frame)
    port = create_detector(Config(debug_dir=str(tmp_path / "port"), **kw),
                           variables, device="cpu")
    calls = []
    heads = port._heads
    monkeypatch.setattr(port, "_heads",
                        lambda *a, **k: calls.append(1) or heads(*a, **k))
    ret = port.run(frame)
    assert len(calls) == 1          # the views come from run's own forward
    ref = cv2.imread(str(tmp_path / "jax" / "pred_hm.png"))
    got = read_frame(str(tmp_path / "port" / "pred_hm.png"))
    assert got.shape == ref.shape == (64, 64, 3)
    assert np.abs(got.astype(int) - ref).max() <= 2
    det = read_frame(str(tmp_path / "port" / "detections.png"))
    assert det.shape == frame.shape and not np.array_equal(det, frame)
    assert set(port.debugger.imgs) == {"pred_hm", "detections"}
    assert sum(len(v) for v in ret["results"].values()) == 8
