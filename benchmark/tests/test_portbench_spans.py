"""The readers of the port's spans (harness/spans.py and the metrics that
use it) on hand-built traces whose numbers are worked out below, and on
a small traced serving run on the CPU."""
import time
from types import SimpleNamespace

import pytest

from portbench_common import small_cell
from benchmark.harness import cells, runner, spans
from benchmark.harness.trace import Trace

# one serving call of 2 frames (us): the stages tile `cp.serve.batch`
# but for 980-990; the device runs 150-350 and 380-580.  Idle: 0-150,
# 350-380, 580-1000 (600 us): 10 before the batch span, upload 90, pre
# 50, net 30, wait 20, post 300, merge 80, 10 in the batch span between
# its stages, 10 after it.
SERVE_HOST = [("bench.run_batch", 0.0, 1000.0),
              ("cp.serve.batch", 10.0, 990.0),
              ("cp.serve.upload", 10.0, 100.0),
              ("cp.serve.pre", 100.0, 200.0),
              ("cp.serve.net", 200.0, 400.0),
              ("aten::conv2d", 250.0, 260.0),
              ("cp.serve.decode", 400.0, 450.0),
              ("cp.serve.fetch", 450.0, 500.0),
              ("cp.serve.wait", 500.0, 600.0),
              ("cp.serve.post", 600.0, 900.0),
              ("cp.serve.merge", 900.0, 980.0)]
KERNELS = [("k1", 150.0, 350.0), ("k2", 380.0, 580.0)]

# two train steps (us), each tiled but for its last 10 us; the device
# runs 0-900 and 1000-1900: idle 900-1000 (adam 60, step's own 10, 30
# between the steps) and 1900-2000 (adam 60, step 10, 30 after).
TRAIN_HOST = [("bench.train_step", 0.0, 1000.0),
              ("bench.train_step", 1000.0, 2000.0)]
for t0 in (0.0, 1000.0):
    TRAIN_HOST += [("cp.train.step", t0, t0 + 970.0),
                   ("cp.train.zero_grad", t0, t0 + 100.0),
                   ("cp.train.forward", t0 + 100.0, t0 + 300.0),
                   ("cp.train.loss", t0 + 300.0, t0 + 400.0),
                   ("cp.train.backward", t0 + 400.0, t0 + 800.0),
                   ("cp.train.adam", t0 + 800.0, t0 + 960.0)]
TRAIN_KERNELS = [("k", 0.0, 900.0), ("k", 1000.0, 1900.0)]


def _ctx(host, kernels, units, mode):
    return SimpleNamespace(trace=Trace(kernels, host), units=units,
                           mode=mode)


def _read(name, ctx):
    return cells.reader(name)(ctx)


def test_self_time_leaves_out_the_children():
    tr = Trace([], [("bench.x", 0.0, 100.0), ("cp.a", 0.0, 100.0),
                    ("cp.b", 20.0, 50.0), ("cp.c", 30.0, 40.0),
                    ("cp.b", 60.0, 70.0), ("aten::add", 0.0, 100.0)])
    own = spans.self_s(tr)
    assert own["cp.a"] == pytest.approx(60e-6)
    assert own["cp.b"] == pytest.approx(30e-6)
    assert own["cp.c"] == pytest.approx(10e-6)
    assert "aten::add" not in own and "bench.x" not in own


def test_idle_is_put_down_to_the_innermost_stage():
    tr = Trace(KERNELS, SERVE_HOST)
    assert spans.idle(tr) == [(0.0, 150.0), (350.0, 380.0), (580.0, 1000.0)]
    by = spans.idle_by_stage(tr)
    want = {"cp.serve.upload": 90, "cp.serve.pre": 50, "cp.serve.net": 30,
            "cp.serve.wait": 20, "cp.serve.post": 300,
            "cp.serve.merge": 80, None: 30}
    assert set(by) == set(want)
    for k, v in want.items():
        assert by[k] == pytest.approx(v * 1e-6), k


def test_serving_readers_by_hand():
    ctx = _ctx(SERVE_HOST, KERNELS, 2, "serve")
    # launch stages' self time: 90 + 100 + (200 - 0: aten is no span)
    # + 50 + 50 = 490 us over 2 frames
    assert _read("dispatch_host_ms_per_frame.infer", ctx) == pytest.approx(
        0.245)
    assert _read("wait_host_ms_per_frame.infer", ctx) == pytest.approx(0.05)
    assert _read("post_host_ms_per_frame.infer", ctx) == pytest.approx(0.19)
    assert _read("idle_in_post_pct.infer", ctx) == pytest.approx(
        100 * 380 / 600)
    assert _read("idle_unattributed_pct.infer", ctx) == pytest.approx(
        100 * 30 / 600)


def test_training_readers_by_hand():
    ctx = _ctx(TRAIN_HOST, TRAIN_KERNELS, 2, "train")
    # stages 960 us a step; the step's own 10 us is no stage's
    assert _read("dispatch_host_ms_per_step.train", ctx) == pytest.approx(
        0.96)
    # idle 200 us: adam 120, unattributed 80 (steps' own 20, outside 60)
    assert _read("idle_unattributed_pct.train", ctx) == pytest.approx(40.0)


@pytest.mark.parametrize("name,mode", [
    ("dispatch_host_ms_per_frame.infer", "serve"),
    ("wait_host_ms_per_frame.infer", "serve"),
    ("post_host_ms_per_frame.infer", "serve"),
    ("idle_in_post_pct.infer", "serve"),
    ("idle_unattributed_pct.infer", "serve"),
    ("idle_unattributed_pct.train", "train"),
    ("dispatch_host_ms_per_step.train", "train")])
def test_nothing_to_read_without_the_spans(name, mode):
    """A program without spans reads None, and so do the idle shares of
    a trace with no kernel (the CPU's)."""
    host = [(n, s, e) for n, s, e in SERVE_HOST + TRAIN_HOST
            if not n.startswith("cp.")]
    assert _read(name, _ctx(host, KERNELS, 2, mode)) is None
    if "idle" in name:
        full = SERVE_HOST if mode == "serve" else TRAIN_HOST
        assert _read(name, _ctx(full, [], 2, mode)) is None


def test_a_small_traced_serving_run_is_accounted_for():
    """The port's stage spans account for the traced sub-window on the
    CPU: dispatch + wait + post, over the frames, within 10 % of it."""
    out = runner.run(small_cell("dla34.serve-batch4"), 2 ** 31 + 11, 0.5,
                     True, "cpu", time.perf_counter())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    frames = 2 * 2          # small_cell: 2 traced calls of 2 frames
    host_s = frames * 1e-3 * (m["dispatch_host_ms_per_frame.infer"]
                              + m["wait_host_ms_per_frame.infer"]
                              + m["post_host_ms_per_frame.infer"])
    assert host_s == pytest.approx(out["device"]["window_s"], rel=0.1)
    assert "idle_in_post_pct.infer" not in m    # no device trace
