"""The port's serving entry points beyond test.py: `infer/run_on_csv.py`
and the video loops of `infer/demo.py`, against the JAX package's and
against `run`, on res_18 at small sizes on the CPU.

* run_on_csv: JAX's `main` and the port's on one reference-format .pth
  write the same rows (paths and labels exact, integer coordinates within
  1, scores within 1e-3; JAX's CSV test, tests/test_debugger.py:54-93,
  with the same weights on both sides); `--eval_batch 1` and `4` write the
  same rows, over frames of two shapes (a change of shape flushes a batch).
* demo: a 3-frame MJPG AVI written with cv2 goes through the three video
  loops (per frame, batched, pipelined), each frame's results equal to
  `run`'s on that frame, and through `main --out_video` in each mode, as
  tests/test_cli_entries.py:197-305 does for JAX's demo.
* without cv2 (`sys.modules["cv2"] = None`) the video path exits naming
  cv2, and the PNG image demo with `--save_overlay` and `--debug 4` runs.
"""
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_common import HEADS, jax_variables

cv2 = pytest.importorskip("cv2")

from centerpoly_tpu.infer import run_on_csv as jrun_on_csv  # noqa: E402
from centerpoly_tpu_torch.configs import Config  # noqa: E402
from centerpoly_tpu_torch.infer import demo, run_on_csv  # noqa: E402
from centerpoly_tpu_torch.infer.detector import create_detector  # noqa: E402
from centerpoly_tpu_torch.utils.png import read_frame, write_frame  # noqa: E402
from centerpoly_tpu_torch.weights import state_dict_from_jax  # noqa: E402

ARGS = ["polydet", "--dataset", "cityscapes", "--arch", "res_18",
        "--input_h", "64", "--input_w", "128", "--K", "8"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """res_18 random weights as a reference-format .pth."""
    variables = jax_variables("res_18", HEADS, 64, 64, 128, seed=2)[1]
    path = tmp_path_factory.mktemp("w") / "res18.pth"
    torch.save({"epoch": 1, "state_dict": state_dict_from_jax(
        variables, "res_18")}, path)
    return str(path)


def _frames(tmp_path, shapes, seed=1):
    rng = np.random.RandomState(seed)
    paths = []
    for i, hw in enumerate(shapes):
        p = str(tmp_path / f"img{i}.png")
        write_frame(p, (rng.rand(*hw, 3) * 255).astype(np.uint8))
        paths.append(p)
    src = tmp_path / "in.csv"
    # repeated paths and extra columns, as a GT CSV has them
    src.write_text("".join(f"{p},0,0,1,1,car\n" for p in paths + paths[:2]))
    return paths, str(src)


def _rows(path):
    rows = []
    for line in open(path).read().splitlines():
        f = line.split(",")
        rows.append((f[0], f[5], float(f[6]),
                     np.array([int(v) for v in f[1:5] + f[7:]])))
    return rows


def _same_rows(got, ref, score_tol):
    """Each reference row has its own counterpart: same path and label,
    score within `score_tol`, every integer within 1."""
    assert len(got) == len(ref)
    free = list(range(len(got)))
    for path, label, score, ints in ref:
        cand = [i for i in free if got[i][0] == path and got[i][1] == label
                and abs(got[i][2] - score) <= score_tol
                and got[i][3].shape == ints.shape
                and np.abs(got[i][3] - ints).max() <= 1]
        assert cand, (path, label, score, ints)
        free.remove(min(cand, key=lambda i: np.abs(got[i][3] - ints).sum()))


def test_run_on_csv_matches_jax(tmp_path, weights, monkeypatch):
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    paths, src = _frames(tmp_path, [(64, 128)] * 3)
    args = ARGS + ["--source_csv", src, "--load_model", weights]
    jrun_on_csv.main(args + ["--target_csv", str(tmp_path / "jax.csv")])
    run_on_csv.main(args + ["--target_csv", str(tmp_path / "port.csv"),
                            "--device", "cpu"])
    ref, got = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "port.csv")
    assert sorted({r[0] for r in got}) == paths
    assert len(got) == 3 * 8 and len(got[0][3]) == 4 + 32
    _same_rows(got, ref, 1e-3)


def test_run_on_csv_batches_by_shape(tmp_path, weights):
    """eval_batch 1 and 4 write the same rows, and so does a batch served
    over two CPU replicas; a frame of another shape flushes the batch
    (a stack of two shapes would raise)."""
    paths, src = _frames(tmp_path, [(64, 128)] * 3 + [(48, 96)] * 2)
    args = ARGS + ["--source_csv", src, "--load_model", weights,
                   "--device", "cpu"]
    outs = {}
    for tag, extra in (("1", []), ("4", ["--eval_batch", "4"]),
                       ("4x2", ["--eval_batch", "4", "--infer_devices", "2"])):
        run_on_csv.main(args + extra + ["--target_csv",
                                        str(tmp_path / f"{tag}.csv")])
        outs[tag] = _rows(tmp_path / f"{tag}.csv")
    assert [r[0] for r in outs["1"]] == sorted(p for p in paths
                                               for _ in range(8))
    # f32 batches sum their convolutions in another order
    _same_rows(outs["4"], outs["1"], 1e-5)
    _same_rows(outs["4x2"], outs["1"], 1e-5)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("v") / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                        (128, 64))
    rng = np.random.RandomState(0)
    for _ in range(3):
        w.write((rng.rand(64, 128, 3) * 255).astype(np.uint8))
    w.release()
    return path


@pytest.fixture(scope="module")
def detector(weights):
    cfg = Config(arch="res_18", input_h=64, input_w=128, K=8,
                 load_model=weights)
    return create_detector(cfg, device="cpu")


@pytest.mark.parametrize("batch,stream", [(1, False), (2, False), (1, True)],
                         ids=["per_frame", "batched", "pipelined"])
def test_video_loops_give_run_results(clip, detector, batch, stream):
    got = list(demo.video_results(detector, demo.open_video(clip),
                                  batch=batch, stream=stream))
    assert len(got) == 3
    # a batch sums its convolutions in another order: run_batch's bound
    # against run in tests/test_torch_detector.py
    atol = 1e-2 if batch > 1 else 1e-4
    for img, ret in got:
        want = detector.run(img)["results"]
        assert set(ret["results"]) == set(want)
        for j in want:
            np.testing.assert_allclose(ret["results"][j], want[j], rtol=0,
                                       atol=atol)
        assert ("rate" in ret) == (batch > 1 or stream)
    first = next(demo.video_results(detector, demo.open_video(clip),
                                    max_frames=1))
    assert np.array_equal(first[0], got[0][0])


@pytest.mark.parametrize("extra,kind", [([], "tot"),
                                        (["--eval_batch", "2"], "(wall)"),
                                        (["--stream"], "pipelined")])
def test_demo_video_entry(tmp_path, clip, weights, capsys, extra, kind):
    out_video = str(tmp_path / "out.avi")
    demo.main(ARGS + extra + ["--demo", clip, "--out_video", out_video,
                              "--max_frames", "2", "--load_model", weights,
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("frame ") == 2 and kind in out
    cap = cv2.VideoCapture(out_video)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 2


def test_demo_video_guards(clip):
    for extra in (["--stream", "--show"], ["--stream", "--eval_batch", "2"]):
        with pytest.raises(SystemExit, match="--stream"):
            demo.main(ARGS + extra + ["--demo", clip, "--device", "cpu"])


def test_without_cv2(tmp_path, clip, weights, monkeypatch, capsys):
    """The image demo reads PNG, draws and writes its overlay and debug
    views without cv2; video input exits naming cv2."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="cv2"):
        demo.main(ARGS + ["--demo", clip, "--device", "cpu"])
    frame = np.random.RandomState(4).randint(0, 256, (96, 160, 3),
                                             dtype=np.uint8)
    path = str(tmp_path / "frame.png")
    write_frame(path, frame)
    demo.main(ARGS + ["--demo", path, "--save_overlay", "--vis_thresh", "0",
                      "--debug", "4", "--debug_dir", str(tmp_path / "dbg"),
                      "--load_model", weights, "--device", "cpu"])
    assert "overlay ->" in capsys.readouterr().out
    overlay = read_frame(str(tmp_path / "frame_polydet.png"))
    assert overlay.shape == frame.shape and not np.array_equal(overlay, frame)
    assert read_frame(str(tmp_path / "dbg" / "detections.png")).shape == \
        frame.shape
    assert read_frame(str(tmp_path / "dbg" / "pred_hm.png")).shape == \
        (64, 128, 3)
    with pytest.raises(SystemExit, match="cv2"):
        demo.run_video(create_detector(Config(arch="res_18", input_h=64,
                                              input_w=128, K=8),
                                       device="cpu"),
                       demo.MemoryCapture([frame]), out_video=str(
                           tmp_path / "x.avi"))
    assert not os.path.exists(tmp_path / "x.avi")
