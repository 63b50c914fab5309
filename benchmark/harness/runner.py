"""One run of a cell: set-up, the measured window, the traced
sub-window, the comparison with the reference, and the result line."""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from . import cells, trace


def device_info(device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, build=None) -> dict:
    """The result line of one run (run.py), by the driver of the cell's
    traffic kind.  `build`: the program's constructor in place of the
    port's (the tests plant faults and the control with it)."""
    device = torch.device(device)
    drv = cells.driver(cell["traffic"]["kind"])(cell, seed, device, build)
    # an end-to-end metric from the device trace: the whole window runs
    # under a trace of the device alone (runs that report the end-to-end
    # metrics only), and set-up warms that trace up
    on_device = [] if traced else [m for m in cell["end_to_end"]
                                   if m.get("source") == "device_trace"]
    if on_device:
        trace.profile(drv.warm_up, with_host=False)
    else:
        drv.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    if on_device:
        e2e = {}
        wtr = trace.profile(lambda: e2e.update(drv.window(seconds)),
                            with_host=False)
        ctx = SimpleNamespace(cell=cell, mode=drv.MODE, trace=wtr,
                              units=e2e["units"], e2e=e2e,
                              launches=drv.launches)
        for m in on_device:
            ctx.metric = m
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                e2e[m["name"]] = value
    else:
        e2e = drv.window(seconds)
    tr = None
    if traced:
        units = {}
        tr = trace.profile(lambda: units.setdefault("n", drv.traced()))
        traced_units = units["n"]
    dev = device_info(device, cell["workload"]["chips"])
    drv.release()
    numbers = drv.check()
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": e2e["attempted"],
           "failed": e2e["failed"]}
    if traced:
        ctx = SimpleNamespace(cell=cell, mode=drv.MODE, trace=tr,
                              units=traced_units, e2e=e2e,
                              launches=drv.launches)
        metrics = {}
        for m in cell["per_layer"]:
            ctx.metric = m
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out.update(metrics=metrics, device=dev,
                   breakdown={"device_ops": tr.device_ops(),
                              "idle_gaps": tr.idle_gaps()})
    else:
        values = dict(e2e, setup_s=setup_s)
        out.update(metrics={m["name"]: {"value": values[m["name"]],
                                        "unit": m["unit"]}
                            for m in cell["end_to_end"]
                            if m["name"] in values},
                   device=dev)
    out["checks"] = checks
    return out
