"""The serving traffic (`"kind": "serve_batch"`): one closed-loop caller
hands `batch` seeded uint8 frames of a pool to the port's detector's
`run_batch` and waits for their per-class results before the next call.
Which frames make up each call is drawn from the seed; every call has
the same size.

`correct` compares the results of `check_calls` calls, drawn from the
seed among those of the window (a reservoir sample, so that the window
keeps no more results than it checks), with the plain reference run in
f32 on the same frames and weights after the window: the input warp
(reference/detect.py), the network (reference/nets.py) with the serving
DCN mode's clamp, and the task's reading of its heads
(benchmark/tasks/<task>.py, which defines the numbers), each read over
the same of the reference run in bf16."""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import cells, control, frames, program, tf32, weights
from benchmark.reference import detect, nets


class Driver:
    """One cell's serving run: the pool, the weights, the program and its
    results."""

    MODE = "serve"

    def __init__(self, cell: dict, seed: int, device, build=None):
        self.conf = conf = cell["config"]
        self.traffic = t = cell["traffic"]
        self.task = cells.task(conf["task"])
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.check_rng = np.random.default_rng([seed, 1])
        self.frames, _ = frames.make_frames(self.rng, t["pool"],
                                            conf["frame_h"], conf["frame_w"],
                                            conf["nbr_points"])
        with torch.device("meta"):
            shapes = weights.shapes_of(self.reference_net())
        sd = weights.make(shapes, seed, conf["weights"]["conv_gain"],
                          conf["weights"]["offset_gain"], self.device)
        sd.update(weights.counters(shapes, self.device))
        self.det = (build or program.detector)(conf, sd, self.device)
        self.state_dict = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.kept = []           # the sampled (frame indices, results)
        self.launches = 0

    def reference_net(self):
        """The reference network with the serving DCN mode's clamp."""
        return nets.build(self.conf, self.conf["serve"]["dcn_kernel"])

    def _next(self):
        return self.rng.choice(len(self.frames), self.traffic["batch"],
                               replace=False)

    def call(self, idx):
        with record_function("bench.run_batch"):
            return self.det.run_batch([self.frames[i] for i in idx])

    def warm_up(self):
        for _ in range(self.traffic["warmup_calls"]):
            self.call(self._next())

    def window(self, seconds: float) -> dict:
        """Back-to-back calls for `seconds`: every call's latency, and the
        frames whose results came back over the whole window (`units`)."""
        lat, failed, frames_done = [], 0, 0
        k = self.traffic["check_calls"]
        n0 = program.dcn_launches() if self.device.type == "cuda" else 0
        t_open = time.perf_counter()
        t_end = t_open
        while t_end - t_open < seconds:
            idx = self._next()
            t0 = time.perf_counter()
            res = self.call(idx)
            t_end = time.perf_counter()
            lat.append(t_end - t0)
            failed += len(res) != len(idx)
            frames_done += len(res)
            n = len(lat)
            slot = n - 1 if n <= k else int(self.check_rng.integers(0, n))
            if slot < k:
                self.kept[slot:slot + 1] = [(idx, res)]
        n = len(lat)
        if self.device.type == "cuda":
            self.launches = (program.dcn_launches() - n0) / n
        q = np.quantile(np.asarray(lat) * 1e3, 0.95)
        return {"attempted": n, "failed": failed, "units": frames_done,
                "infer_frames_per_s": frames_done / (t_end - t_open),
                "infer_batch_p95_ms": float(q)}

    def traced(self):
        n = self.traffic["trace_calls"]
        for _ in range(n):
            self.call(self._next())
        return n * self.traffic["batch"]

    def release(self):
        del self.det
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """{number: value} of the sampled calls against the reference."""
        conf, dev, task = self.conf, self.device, self.task
        net = self.reference_net().to(dev).eval()
        net.load_state_dict(self.state_dict)
        net16 = self.reference_net().to(dev).eval()
        net16.load_state_dict(self.state_dict)
        net16.to(torch.bfloat16)
        trans, to_frame = detect.frame_geometry(
            conf["frame_h"], conf["frame_w"], conf["input_h"],
            conf["input_w"], conf["down_ratio"])
        got, own = [], []
        with torch.no_grad(), tf32.switch(False):
            for idx, results in self.kept:
                u8 = torch.from_numpy(np.stack([self.frames[i]
                                                for i in idx])).to(dev)
                x = detect.preprocess(u8, trans, conf["input_h"],
                                      conf["input_w"], conf["mean"],
                                      conf["std"])
                ref = task.decode(net(x)[-1], to_frame)
                bf16 = task.served_results(net16(x.bfloat16())[-1],
                                           to_frame, conf)
                for j in range(len(idx)):
                    own.append(task.frame_gaps(bf16[j]["results"], ref, j,
                                               conf))
                    got.append(task.frame_gaps(
                        results[j]["results"] if j < len(results) else None,
                        ref, j, conf))
        return task.numbers(got, own, conf)


def readings(cell: dict, seed: int, control_run: bool, seconds: float,
             device) -> dict:
    """The numbers of one seed at the cell's own load (a window of
    `seconds`), of the program or, with `control_run`, of the control
    (the reference at fp8 in its place; benchmark/readings.py)."""
    drv = Driver(cell, seed, device,
                 control.Fp8Detector if control_run else None)
    drv.warm_up()
    calls = drv.window(seconds)["attempted"]
    drv.release()
    return {"calls": calls, **drv.check()}
