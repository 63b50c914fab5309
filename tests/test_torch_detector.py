"""The inference slice as a whole: the PyTorch port's detector against the
JAX package's, on one seeded uint8 frame and one set of random weights.

Input 64x128 (from a 128x256 frame), head_conv 32, K=16, f32 on the CPU.
The JAX detector's host pre-shrink (cv2) is replaced by the identity so
both sides warp the same full frame.  Per-class detections must agree to
1e-3 in score and 1e-2 px in source-image coordinates (the head maps agree
to ~1e-5; coordinates are scaled 8x from the output grid).
"""
import numpy as np
import pytest
import torch

from torch_port_common import HEADS, jax_dla_variables, rel_max

from centerpoly_tpu.configs import Config as JaxConfig
from centerpoly_tpu.infer import detector as jdet
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.infer import demo
from centerpoly_tpu_torch.infer import detector as detector_module
from centerpoly_tpu_torch.infer.detector import create_detector
from centerpoly_tpu_torch.kernels import dcn

KW = dict(input_h=64, input_w=128, head_conv=32, K=16, mixed_precision=False)


@pytest.fixture(scope="module")
def variables():
    # offsets of up to ~15 px, some past the rowband:6 band; seed 8 leaves
    # no two of the top-K scores closer than 4e-4
    return jax_dla_variables(HEADS, 32, 64, 128, seed=8)[1]


@pytest.fixture(scope="module")
def halo_variables():
    # offset convs at gain 0.3: offsets of up to ~20 px, half of them past
    # +-4 at the coarse nodes.  At gain 1 most halo-clamped samples stay in
    # the image, and the random network turns so sensitive that a batch of
    # 2 (convolutions summed in another order) moves a vertex by 3e-2 px
    return jax_dla_variables(HEADS, 32, 64, 128, seed=8, offset_gain=0.3)[1]


@pytest.fixture
def jax_env(monkeypatch):
    """The JAX Config writes CENTERPOLY_PALLAS_DCN into os.environ; start
    unset and hand the variable back unset so no later test sees it."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    monkeypatch.setattr(jdet.BaseDetector, "_shrink_for_send",
                        lambda self, image, trans, h, w: (image, trans))
    yield
    JaxConfig(**KW)  # dcn_kernel auto: restores the variable's prior value


def _frame(seed=11):
    return np.random.RandomState(seed).randint(0, 256, (128, 256, 3),
                                               dtype=np.uint8)


def _same_detections(got, ref) -> int:
    """Per class the same rows: scores and depth within 1e-3, coordinates
    within 1e-2 px.  Returns the number of rows."""
    n = 0
    for j in range(1, 9):
        g, r = np.asarray(got[j]), np.asarray(ref[j])
        assert g.shape == r.shape, j
        n += len(r)
        np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=0, atol=1e-3)
        coords = [i for i in range(g.shape[1]) if i != 4 and i != g.shape[1] - 1]
        np.testing.assert_allclose(g[:, coords], r[:, coords], rtol=0,
                                   atol=1e-2)
        np.testing.assert_allclose(g[:, -1], r[:, -1], rtol=0, atol=1e-3)
    return n


@pytest.mark.parametrize("mode", ["rowband:6", "off", "halo:4"])
def test_run_matches_jax(jax_env, request, mode):
    """In halo mode the JAX detector runs its clipped XLA fallback on the
    CPU (deform_conv.py:1012), which has the halo kernel's forward."""
    variables = request.getfixturevalue(
        "halo_variables" if mode.startswith("halo") else "variables")
    frame = _frame()
    ref = jdet.create_detector(JaxConfig(dcn_kernel=mode, **KW),
                               variables).run(frame)
    port = create_detector(Config(dcn_kernel=mode, **KW), variables,
                           device="cpu")
    got = port.run(frame)
    assert set(got) == set(ref)
    assert _same_detections(got["results"], ref["results"]) == 16
    # the batch path gives the same detections as run(), within the same
    # bounds (a batch of 2 sums its convolutions in another order)
    batch = port.run_batch([frame, _frame(12)])
    for j in range(1, 9):
        np.testing.assert_allclose(batch[0]["results"][j],
                                   got["results"][j], rtol=0, atol=1e-2)


def test_no_card_raises_without_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cpu"):
        create_detector(Config(**KW))


def test_cpu_run_launches_no_kernel():
    before = dict(dcn.launches)
    ret = create_detector(Config(**KW), device="cpu").run(_frame())
    assert dcn.launches == before
    assert {"tot", "load", "pre", "net", "dec", "post", "merge"} <= set(ret)
    assert sum(len(v) for v in ret["results"].values()) == 16


def test_config_dcn_kernel():
    cfg = Config()
    assert cfg.prefer_fast_inference_dcn() and cfg.dcn_kernel == "rowband:6"
    cfg = Config(dcn_kernel="off")
    assert not cfg.prefer_fast_inference_dcn() and cfg.dcn_kernel == "off"
    assert Config().heads == {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
    with pytest.raises(ValueError):
        Config(dcn_kernel="fused")
    # a user's halo:R is left alone, and reaches every DCN node
    cfg = Config(dcn_kernel="halo:4", **KW)
    assert not cfg.prefer_fast_inference_dcn() and cfg.dcn_kernel == "halo:4"
    det = create_detector(cfg, device="cpu")
    clamps = [m.clamp for m in det.model.modules() if hasattr(m, "clamp")]
    assert clamps == [{"max_offset": 4}] * 16
    with pytest.raises(ValueError, match="halo:x"):
        create_detector(Config(dcn_kernel="halo:x", **KW), device="cpu")


@pytest.fixture(scope="module")
def stream_case(halo_variables):
    """halo:4, two scales (so each frame dispatches two forwards), four
    frames and run()'s results for each."""
    cfg = Config(dcn_kernel="halo:4", test_scales=(1.0, 0.5), **KW)
    det = create_detector(cfg, halo_variables, device="cpu")
    frames = [_frame(s) for s in (11, 12, 13, 14)]
    return det, frames, [det.run(f)["results"] for f in frames]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_run_stream_matches_run(stream_case, depth):
    """run_stream yields, frame by frame and in order, what run() gives."""
    det, frames, refs = stream_case
    streamed = list(det.run_stream(iter(frames), depth=depth))
    assert len(streamed) == len(frames)
    for got, ref in zip(streamed, refs):
        assert set(got) == set(ref)
        for j in ref:
            np.testing.assert_array_equal(got[j], ref[j])


def test_config_from_args():
    cfg = Config.from_args(["polydet", "--arch", "dla_34", "--K", "7",
                            "--test_scales", "1,0.5", "--no_mixed_precision",
                            "--flip_test"])
    assert (cfg.K, cfg.test_scales, cfg.mixed_precision, cfg.flip_test) == (
        7, (1.0, 0.5), False, True)


def test_flip_and_multiscale_run(variables):
    """flip TTA and two scales with soft-NMS merge run end to end."""
    cfg = Config(flip_test=True, test_scales=(1.0, 0.5), **KW)
    ret = create_detector(cfg, variables, device="cpu").run(_frame())
    rows = np.concatenate([np.asarray(v) for v in ret["results"].values()])
    assert rows.shape == (16, 4 + 1 + 32 + 1) and np.isfinite(rows).all()


@pytest.mark.parametrize("extra", [
    {"flip_test": True}, {"test_scales": (1.0, 0.5)}, {"nms": True},
    {"flip_test": True, "test_scales": (1.0, 0.5), "nms": True}],
    ids=["flip_test", "two_scales", "nms", "all_three"])
def test_detector_paths_match_jax(jax_env, variables, extra):
    """The flip-TTA average, two test scales merged by soft-NMS, and
    soft-NMS at one scale, against the JAX detector, within
    test_run_matches_jax's bounds."""
    frame = _frame()
    ref = jdet.create_detector(JaxConfig(**extra, **KW), variables).run(frame)
    got = create_detector(Config(**extra, **KW), variables,
                          device="cpu").run(frame)
    assert _same_detections(got["results"], ref["results"]) == 16


@pytest.mark.parametrize("hw", [(100, 200), (60, 120)])
def test_keep_res_matches_jax(jax_env, halo_variables, hw):
    """fix_res=False: the network input is the frame padded to
    (h | 31) + 1, (w | 31) + 1 (128x224 for a 100x200 frame; 64x128 for
    60x120, with a pad border).  The halo fixture's weights (offset gain
    0.3): at gain 1 the random net at 128x224 differs from itself by ~1e-3
    relative in the head maps when its input moves by 1e-6 relative, and
    one detection changes class at the K-th score.  The metas and network
    inputs must be equal, every head map within 2e-3 relative max
    (tests/test_torch_dla.py's bound), the detections within
    test_run_matches_jax's bounds."""
    frame = np.random.RandomState(13).randint(0, 256, (*hw, 3),
                                              dtype=np.uint8)
    cfg = dict(KW, fix_res=False)
    jd = jdet.create_detector(JaxConfig(**cfg), halo_variables)
    pd = create_detector(Config(**cfg), halo_variables, device="cpu")
    jtrans, jmeta = jd.pre_process_meta(*hw, 1.0)
    trans, meta = pd.pre_process_meta(*hw, 1.0)
    assert {k: np.asarray(v).tolist() for k, v in meta.items()} == {
        k: np.asarray(v).tolist() for k, v in jmeta.items()}
    assert (meta["inp_h"], meta["inp_w"]) == ((hw[0] | 31) + 1,
                                              (hw[1] | 31) + 1)
    np.testing.assert_allclose(trans, jtrans, rtol=1e-6, atol=1e-6)
    size = (meta["inp_h"], meta["inp_w"])
    jx = jd._pre_jit(frame, jtrans, jd.mean, jd.std, size)
    x = pd._pre_device(torch.from_numpy(frame)[None], trans, size)
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), np.asarray(jx),
                               rtol=0, atol=1e-4)
    ref_heads = jd._heads(jd.variables, jx)
    with torch.no_grad():
        heads = pd._heads(x)
    for k, r in ref_heads.items():
        assert rel_max(heads[k].permute(0, 2, 3, 1).numpy(), r) < 2e-3, k
    assert _same_detections(pd.run(frame)["results"],
                            jd.run(frame)["results"]) == 16


def test_demo_on_a_folder(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    cv2.imwrite(str(tmp_path / "a.png"), _frame())
    demo.main(["polydet", "--demo", str(tmp_path), "--device", "cpu",
               "--input_h", "64", "--input_w", "128", "--head_conv", "32",
               "--save_overlay"])
    out = capsys.readouterr().out
    assert "a.png: tot" in out and (tmp_path / "a_polydet.png").exists()


def test_demo_halo(tmp_path, capsys, monkeypatch):
    """`--dcn_kernel halo:4` reaches the demo's detector."""
    cv2 = pytest.importorskip("cv2")
    cv2.imwrite(str(tmp_path / "a.png"), _frame())
    made = []

    def spy(cfg, *args, **kw):
        det = create_detector(cfg, *args, **kw)
        made.append([m.clamp for m in det.model.modules()
                     if hasattr(m, "clamp")])
        return det

    monkeypatch.setattr(detector_module, "create_detector", spy)
    demo.main(["polydet", "--demo", str(tmp_path / "a.png"), "--device",
               "cpu", "--input_h", "64", "--input_w", "128", "--head_conv",
               "32", "--dcn_kernel", "halo:4"])
    assert "a.png: tot" in capsys.readouterr().out
    assert made == [[{"max_offset": 4}] * 16]
