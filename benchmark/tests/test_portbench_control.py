"""`correct` has teeth: with the timed path broken underneath, or the
control (the reference one precision below the configuration's: fp8 for
the bf16 serving, TF32 for the f32 training) in the program's place, a
run at a small size on the CPU reads not correct under the cells' own
limits."""
import time

import numpy as np
import pytest

from portbench_common import small_cell
from benchmark.harness import cells, control, program, runner

train_step = cells.module("drivers", "train_step")

SEED = 2 ** 31 + 99


class _Wrapped:
    def __init__(self, det):
        self.det = det


class AlteredAnswer(_Wrapped):
    """One served row's polygon moved by 50 px where it is produced."""

    def run_batch(self, images):
        out = self.det.run_batch(images)
        rows = next(r for r in out[0]["results"].values() if len(r))
        rows[0, 5:37] += 50.0
        return out


class HalfBatch(_Wrapped):
    """Results for the first half of the frames only."""

    def run_batch(self, images):
        return self.det.run_batch(images[:len(images) // 2])


class RowsDropped(_Wrapped):
    """Every frame's results cut to their best row of each class."""

    def run_batch(self, images):
        out = self.det.run_batch(images)
        for frame in out:
            frame["results"] = {c: r[np.argsort(-r[:, 4])[:1]]
                                for c, r in frame["results"].items()}
        return out


class WrongClass(_Wrapped):
    """Every row filed under the next class (the last under the first)."""

    def run_batch(self, images):
        out = self.det.run_batch(images)
        for frame in out:
            res = frame["results"]
            n = len(res)
            frame["results"] = {c % n + 1: res[c] for c in res}
        return out


def _serve(build):
    cell = small_cell("dla34.serve-batch4")
    return runner.run(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                      build=build)


def test_serving_sound_run_is_correct():
    assert _serve(None)["correct"]


@pytest.mark.parametrize("fault", [AlteredAnswer, HalfBatch, RowsDropped,
                                   WrongClass])
def test_serving_fault_is_not_correct(fault):
    out = _serve(lambda conf, sd, dev: fault(program.detector(conf, sd,
                                                              dev)))
    assert not out["correct"], out["checks"]


def test_serving_fp8_control_is_not_correct():
    out = _serve(control.Fp8Detector)
    assert not out["correct"], out["checks"]


def _unchanged(conf, sd, dev):
    """A step that returns its state unchanged (it computes the loss and
    gradients, and puts every parameter and statistic back)."""
    state, step = program.train_step(conf, sd, dev)

    def stuck(st, batch):
        keep = {k: v.clone() for k, v in st.model.state_dict().items()}
        st, stats = step(st, batch)
        st.model.load_state_dict(keep)
        return st, stats
    return state, stuck


def _half(conf, sd, dev):
    """Half of each batch left out, the mean taken over the rest."""
    state, step = program.train_step(conf, sd, dev)
    return state, lambda st, b: step(st, {k: v[:len(v) // 2]
                                          for k, v in b.items()})


@pytest.mark.parametrize("fault", [_unchanged, _half])
def test_training_fault_is_not_correct(fault):
    cell = small_cell("dla34.train-b16")
    out = runner.run(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                     build=fault)
    assert not out["correct"], out["checks"]


def test_training_tf32_control_is_not_correct():
    """The reference with TF32's rounding of the convolutions' operands
    (what the program computes with its TF32 path switched on, which no
    CPU runs) in the program's place."""
    cell = small_cell("dla34.train-b16")
    drv = train_step.Driver(cell, SEED, "cpu",
                            build=lambda *a: (None, None))
    numbers = train_step.compare(drv.reference(tf32_operands=True),
                                 drv.reference())
    assert any(numbers[k] > v for k, v in cell["limits"].items()), numbers
