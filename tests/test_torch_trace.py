"""The port's spans (utils/timers.py::span) in the serving and training
paths, read from a CPU profile the way the benchmark reads a card's: the
stage spans of `run_batch`, `run`, `run_stream` and a train step, in
order, inside their parent and tiling it; with no profiler, no
record_function at all.

A DLA-34 at 64x128 (head_conv 16, K 16) with random weights, f32 on the
CPU; the train step on a batch of 2 from the port's sampler."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (CityscapesMeta, CocoPolyAnnotations,
                                       Loader, PolydetSampler)
from centerpoly_tpu_torch.data.fixture import write_rect_fixture
from centerpoly_tpu_torch.infer.detector import create_detector
from centerpoly_tpu_torch.losses import PolydetLossConfig
from centerpoly_tpu_torch.models import create_model
from centerpoly_tpu_torch.train import state as tstate
from centerpoly_tpu_torch.train.step import make_train_step, to_device
from centerpoly_tpu_torch.utils import timers

H, W = 64, 128
KW = dict(input_h=H, input_w=W, head_conv=16, K=16, mixed_precision=False)
LOSS = dict(rep="polar", poly_loss="l1+iou", poly_order=True)
SERVE_STAGES = ["cp.serve.upload", "cp.serve.upload", "cp.serve.pre",
                "cp.serve.net", "cp.serve.decode", "cp.serve.fetch",
                "cp.serve.wait", "cp.serve.post", "cp.serve.merge"]
RUN_STAGES = ["cp.run.load", "cp.run.pre", "cp.run.net", "cp.run.dec",
              "cp.run.post", "cp.run.merge"]
TRAIN_STAGES = ["cp.train.zero_grad", "cp.train.forward", "cp.train.loss",
                "cp.train.backward", "cp.train.adam"]


def _frame(seed):
    return np.random.RandomState(seed).randint(0, 256, (2 * H, 2 * W, 3),
                                               dtype=np.uint8)


def _spans(fn):
    """fn() under a CPU profile -> [(name, start_us, end_us)] of its
    `cp.*` spans by start, and fn's result."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    res = prof.profiler.kineto_results
    got = sorted(((ev.name(), ev.start_ns() / 1e3,
                   (ev.start_ns() + ev.duration_ns()) / 1e3)
                  for ev in res.events() if ev.name().startswith("cp.")),
                 key=lambda x: (x[1], -x[2]))
    return got, out


def _check_tiled(found, parent, stages):
    """One `parent` span holds `stages` in order, each a leaf inside it,
    and they cover all but 5 % of it."""
    (p, ps, pe), *inner = found
    assert p == parent and [n for n, _, _ in inner] == stages
    assert all(ps <= s <= e <= pe for _, s, e in inner)
    assert all(e0 <= s1 for (_, _, e0), (_, s1, _) in zip(inner, inner[1:]))
    covered = sum(e - s for _, s, e in inner)
    assert covered >= 0.95 * (pe - ps), (covered, pe - ps)


@pytest.fixture(scope="module")
def detector():
    return create_detector(Config(**KW), device="cpu")


@pytest.fixture(scope="module")
def train_batch(tmp_path_factory):
    root = write_rect_fixture(str(tmp_path_factory.mktemp("fx")), 2, 0,
                              2 * H, 2 * W)
    cfg = Config(input_h=H, input_w=W, head_conv=16, **LOSS)
    meta = CityscapesMeta(root)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    return to_device(next(iter(Loader(sampler, 2, 2, shuffle=False))),
                     "cpu")


def _train_state(seed=0):
    torch.manual_seed(seed)
    net = create_model("dla_34", Config(**LOSS).heads, 16)
    return tstate.create_train_state(net, base_lr=2e-4)


def test_run_batch_stages_tile_the_call(detector):
    detector.run_batch([_frame(1), _frame(2)])        # warm
    found, out = _spans(lambda: detector.run_batch([_frame(1), _frame(2)]))
    assert len(out) == 2
    _check_tiled(found, "cp.serve.batch", SERVE_STAGES)


def test_run_stages_tile_the_call_and_keep_the_keys(detector):
    detector.run(_frame(3))
    found, ret = _spans(lambda: detector.run(_frame(3)))
    _check_tiled(found, "cp.run", RUN_STAGES)
    assert set(ret) == {"results", "tot", "load", "pre", "net", "dec",
                        "post", "merge"}
    stages = sum(ret[k] for k in ("load", "pre", "net", "dec", "post",
                                  "merge"))
    # on the CPU every stage is on the host clock, inside the wall time
    assert 0 < stages <= ret["tot"]


def test_run_stream_stages_carry_the_frame(detector, monkeypatch):
    calls = []
    real = timers.record_function

    def recorded(name, args=None):
        calls.append((name, args))
        return real(name, args)

    monkeypatch.setattr(timers, "record_function", recorded)
    frames = [_frame(4), _frame(5), _frame(6)]
    found, out = _spans(lambda: list(detector.run_stream(frames, depth=2)))
    assert len(out) == 3
    # two frames in flight; on the CPU the results need no wait
    want = [("stream.upload", 0), ("stream.dispatch", 0),
            ("stream.upload", 1), ("stream.dispatch", 1),
            ("stream.post", 0), ("stream.merge", 0),
            ("stream.upload", 2), ("stream.dispatch", 2),
            ("stream.post", 1), ("stream.merge", 1),
            ("stream.post", 2), ("stream.merge", 2)]
    assert calls == [(f"cp.{n}", str(i)) for n, i in want]
    assert [n for n, _, _ in found] == [f"cp.{n}" for n, _ in want]


def test_train_step_stages_tile_the_step(train_batch):
    st = _train_state()
    step = make_train_step(PolydetLossConfig(**LOSS))
    st, _ = step(st, train_batch)                     # warm
    found, (st, stats) = _spans(lambda: step(st, train_batch))
    assert torch.isfinite(stats["loss"])
    _check_tiled(found, "cp.train.step", TRAIN_STAGES)


@pytest.mark.parametrize("grad_bucket", [False, True])
def test_group_train_step_has_an_allreduce_stage(train_batch, tmp_path,
                                                 grad_bucket):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        st = _train_state()
        step = make_train_step(PolydetLossConfig(**LOSS),
                               group=dist.group.WORLD,
                               grad_bucket=grad_bucket)
        st, _ = step(st, train_batch)
        found, _ = _spans(lambda: step(st, train_batch))
    finally:
        dist.destroy_process_group()
    _check_tiled(found, "cp.train.step",
                 TRAIN_STAGES[:4] + ["cp.train.allreduce", "cp.train.adam"])


def test_no_profiler_no_record_function(detector, train_batch, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span entered record_function")

    monkeypatch.setattr(timers, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert len(detector.run_batch([_frame(1), _frame(2)])) == 2
    assert "net" in detector.run(_frame(3))
    assert len(list(detector.run_stream([_frame(4), _frame(5)]))) == 2
    st, stats = make_train_step(PolydetLossConfig(**LOSS))(_train_state(),
                                                           train_batch)
    assert torch.isfinite(stats["loss"])
