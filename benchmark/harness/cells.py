"""A cell by name, and the code of each of its parts by name.

A cell is its workload entry in BENCHMARK.json, its configuration's
file, its traffic mix (benchmark/traffic/<mix>.json), its limits
(benchmark/limits/<cell>.json) and the metrics it reports.  The code
that a cell runs is found by the names in those files:

  benchmark/drivers/<kind>.py    the traffic mix's `kind`: `Driver`,
                                 which makes the inputs from the seed,
                                 drives the program's entry and compares
                                 its outputs with the reference;
  benchmark/tasks/<task>.py      the configuration's `task`: its training
                                 targets, its reference loss and the
                                 comparison of its served rows;
  benchmark/metrics/<stem>.py    a per-layer metric `<stem>.<part>`:
                                 `read(ctx)`;
  benchmark/reference/archs/<arch>.py  the configuration's `arch`: the
                                 reference network (reference/nets.py).

So a later cell, mix, task, network or metric is new files and
entries, with no edit of a file that is there."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
_loaded = {}


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _read(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def load(name: str) -> dict:
    """{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer", "run_seconds"} of the cell `name`; KeyError for an
    unknown cell.  An end-to-end metric without a `workloads` list is
    every cell's; a per-layer metric is the cells' that it lists."""
    m = manifest()
    work = next((w for w in m["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{', '.join(w['name'] for w in m['workloads'])}")
    conf = next(c for c in m["configs"] if c["name"] == work["config"])
    return {"workload": work,
            "config": _read(conf["file"]),
            "traffic": _read(f"benchmark/traffic/{work['traffic']}.json"),
            "limits": _read(f"benchmark/limits/{name}.json"),
            "end_to_end": [e for e in m["end_to_end"]
                           if name in e.get("workloads", [name])],
            "per_layer": [p for p in m["per_layer"]
                          if name in p["workloads"]],
            "run_seconds": m["run_seconds"]}


def module(folder: str, stem: str):
    """The module benchmark/<folder>/<stem>.py, loaded once; KeyError
    where there is none."""
    path = os.path.join(BENCH, folder, stem + ".py")
    if path not in _loaded:
        if not os.path.isfile(path):
            raise KeyError(f"no {folder}/{stem}.py under {BENCH}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark.{folder}.{stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def driver(kind: str):
    """The `Driver` class of a traffic mix's kind."""
    return module("drivers", kind).Driver


def task(name: str):
    """The module of a configuration's task."""
    return module("tasks", name)


def reader(metric: str):
    """The `read(ctx)` of a per-layer metric: benchmark/metrics/<name up
    to its first dot>.py."""
    return module("metrics", metric.split(".")[0]).read
