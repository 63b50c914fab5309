"""BENCHMARK.json against the benchmark's contract, every name resolving
to its file, and runs of the harness on the CPU at a small size."""
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from portbench_common import ROOT, small_cell
from benchmark.harness import cells, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = cells.manifest()
SERVE_NUMBERS = {"score_gap", "kth_score_gap", "poly_gap", "depth_gap",
                 "row_count_gap"}
TRAIN_NUMBERS = {"loss_gap", "grad_norm_gap", "update_norm_gap"}


def test_manifest_keys_and_limits():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" and "workloads" not in e
               for e in m["end_to_end"])
    for p in m["per_layer"]:
        assert set(p) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_text():
    m = MANIFEST
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    assert len(names) == len(set(names))
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = cells.load(name)
    kind = cell["traffic"]["kind"]
    assert callable(cells.driver(kind))
    assert callable(cells.task(cell["config"]["task"]).targets)
    want = SERVE_NUMBERS if kind == "serve_batch" else TRAIN_NUMBERS
    assert cell["limits"] and set(cell["limits"]) <= want
    reported = {e["name"] for e in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell["per_layer"]
    for p in cell["per_layer"]:
        assert callable(cells.reader(p["name"]))
        assert p["moves"] in reported


TOY_DRIVER = '''
import torch
from torch.profiler import record_function


class Driver:
    MODE = "serve"

    def __init__(self, cell, seed, device, build=None):
        self.x = torch.full((8,), float(seed))
        self.launches = 0

    def warm_up(self):
        pass

    def window(self, seconds):
        return {"attempted": 3, "failed": 0, "toy_per_s": 2.5}

    def traced(self):
        with record_function("bench.toy"):
            self.x = self.x + 1
        return 1

    def release(self):
        pass

    def check(self):
        return {"gap": 0.25}
'''
TOY_METRIC = '''
def read(ctx):
    return ctx.e2e[ctx.metric["moves"]] * 2
'''


@pytest.mark.parametrize("traced", [False, True])
def test_a_new_kind_and_metric_resolve_with_no_edit(tmp_path, monkeypatch,
                                                    traced):
    """A later cell's driver and metric are new files found by name: here
    in a directory of their own, run through the unchanged runner."""
    (tmp_path / "drivers").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "drivers" / "toy_kind.py").write_text(TOY_DRIVER)
    (tmp_path / "metrics" / "toy_metric.py").write_text(TOY_METRIC)
    monkeypatch.setattr(cells, "BENCH", str(tmp_path))
    cell = {"workload": {"name": "toy.cell", "chips": 1},
            "config": {}, "traffic": {"kind": "toy_kind"},
            "limits": {"gap": 0.5},
            "end_to_end": [{"name": "toy_per_s", "unit": "1/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "toy_metric.serve", "unit": "1/s",
                           "moves": "toy_per_s"}]}
    out = runner.run(cell, 7, 0.1, traced, "cpu", time.perf_counter())
    assert out["correct"] and out["checks"] == {
        "gap": {"value": 0.25, "limit": 0.5}}
    if traced:
        assert out["metrics"] == {"toy_metric.serve": {"value": 5.0,
                                                       "unit": "1/s"}}
    else:
        assert out["metrics"]["toy_per_s"]["value"] == 2.5
    with pytest.raises(KeyError):
        cells.driver("no_such_kind")


def test_configuration_files_are_their_own():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_each_metric_moves_an_end_to_end_metric_of_its_cells():
    for p in MANIFEST["per_layer"]:
        for w in p["workloads"]:
            e2e = {e["name"] for e in cells.load(w)["end_to_end"]}
            assert p["moves"] in e2e, (p["name"], w)


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dla34.serve-batch4", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_run_without_a_card_fails_and_prints_no_result():
    p = _run_py(ROOT)
    assert p.returncode != 0
    assert "CUDA device" in p.stderr and p.stdout == ""


def test_run_beside_nothing_but_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("name", ["dla34.serve-batch4",
                                  "smallhourglass.serve-batch4"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_small_serving_run_on_the_cpu(name, traced):
    cell = small_cell(name)
    out = runner.run(cell, 2 ** 31 + 7, 0.5, traced, "cpu",
                     time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell["limits"])
    if traced:
        assert "breakdown" in out and "window_s" in out["device"]
        assert {"frames_per_s.infer", "batch_p95_ms.infer"} <= set(
            out["metrics"])
    else:
        # the CPU has no device trace: the card's run adds
        # infer_device_ms_per_frame
        assert set(out["metrics"]) == {"setup_s"}


def test_device_time_a_frame_is_the_union_of_the_windows_kernels():
    """infer_device_ms_per_frame: overlapping kernels count once, gaps
    not at all, over every frame of the window."""
    from types import SimpleNamespace
    from benchmark.harness.trace import Trace
    tr = Trace([("a", 100.0, 600.0), ("b", 400.0, 900.0),
                ("c", 2000.0, 2500.0)], [])
    ctx = SimpleNamespace(trace=tr, units=4)
    read = cells.reader("infer_device_ms_per_frame")
    assert read(ctx) == pytest.approx(1.3 / 4)
    assert tr.window_s == pytest.approx(2.4e-3)
    assert read(SimpleNamespace(trace=Trace([], []), units=4)) is None


def test_a_small_training_run_on_the_cpu():
    cell = small_cell("smallhourglass.train-b16")
    out = runner.run(cell, 11, 0.5, False, "cpu", time.perf_counter())
    assert out["attempted"] > 0 and set(out["checks"]) == TRAIN_NUMBERS
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
    assert all(c["value"] < 1 for c in out["checks"].values())


@pytest.mark.gpu
def test_a_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dla34.serve-batch4", "--seed", "3000000021", "--seconds", "2",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["dcn_launches.infer"]["value"] == 16
    assert out["device"]["platform"] == "gpu"
