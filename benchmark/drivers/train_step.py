"""The training traffic (`"kind": "train_step"`): `pool_batches` seeded
batches of `batch` images at the network's input size (harness/frames.py)
with their task's targets (benchmark/tasks/<task>.py), kept on the
device, stepped through in turn by the port's `train_step(state, batch)`,
with TF32 on or off as the configuration states.

Set-up builds the one train state that the window steps, and drives it
through its first three steps on the first three batches (all rows
differ).  `correct` holds those three steps to the plain reference
(reference/nets.py, the task's reference loss, reference/adam.py) from
the same weights on the same batches, in f32 with TF32 off as the
configuration states, after the window:

  loss_gap         the largest relative gap of the three steps' losses;
  grad_norm_gap    the first gradient, as Adam got it (its first moment
                   after one step over 1 - beta1), by leaf: the gap
                   between the program's norm and the reference's over
                   the larger of the reference's and the median leaf's,
                   at its worst leaf;
  update_norm_gap  the change of each parameter and BatchNorm statistic
                   after the three steps, by leaf as above, at its worst
                   leaf; parameters whose reference gradient is under a
                   thousandth of the median leaf's (their change is
                   Adam's reading of round-off) are left out."""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import cells, control, frames, program, tf32, weights
from benchmark.reference import adam, nets

CHECKED_STEPS = 3


def make_batch(imgs, objects, conf, device) -> dict:
    """Frames at the input size and their objects -> the step's batch on
    the device: input an NCHW view of NHWC f32 data, the targets as the
    task's `targets` gives them."""
    out_hw = (conf["input_h"] // conf["down_ratio"],
              conf["input_w"] // conf["down_ratio"])
    task = cells.task(conf["task"])
    tg = [task.targets(o, (conf["input_h"], conf["input_w"]), out_hw, conf)
          for o in objects]
    batch = {k: torch.from_numpy(np.stack([t[k] for t in tg])).to(device)
             for k in tg[0]}
    x = torch.from_numpy(np.stack(imgs)).to(device).float() / 255.0
    mean = torch.tensor(conf["mean"], device=device)
    std = torch.tensor(conf["std"], device=device)
    batch["input"] = ((x - mean) / std).permute(0, 3, 1, 2)
    return batch


def leaf_norms(named) -> dict:
    return {k: v for k, v in zip(
        [n for n, _ in named],
        torch.stack([t.detach().float().norm() for _, t in named])
        .cpu().tolist())}


def stats_buffers(model):
    return [(n, b) for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


class Driver:
    """One cell's training run: the pool of batches, the weights, the
    program's train state and its readings of the first steps."""

    MODE = "train"

    def __init__(self, cell: dict, seed: int, device, build=None):
        self.conf = conf = cell["config"]
        self.traffic = t = cell["traffic"]
        self.device = torch.device(device)
        rng = np.random.default_rng(seed)
        b = t["batch"]
        imgs, objs = frames.make_frames(rng, b * t["pool_batches"],
                                        conf["input_h"], conf["input_w"],
                                        conf["nbr_points"])
        self.batches = [make_batch(imgs[i:i + b], objs[i:i + b], conf,
                                   self.device)
                        for i in range(0, len(imgs), b)]
        with torch.device("meta"):
            shapes = weights.shapes_of(nets.build(conf))
        sd = weights.make(shapes, seed, conf["weights"]["conv_gain"],
                          conf["weights"]["offset_gain"], self.device)
        sd.update(weights.counters(shapes, self.device))
        self.theta0 = {k: v.cpu() for k, v in sd.items()}
        self.state, self.step = (build or program.train_step)(
            conf, sd, self.device)
        del sd
        self.tf32 = conf["train"]["tf32"]
        self.n = 0
        self.launches = 0

    def _step(self):
        with record_function("bench.train_step"), tf32.switch(self.tf32):
            self.state, stats = self.step(
                self.state, self.batches[self.n % len(self.batches)])
        self.n += 1
        return stats

    def warm_up(self):
        """The first three steps, with the program's readings of them."""
        model, opt = self.state.model, self.state.optimizer
        losses = []
        for i in range(CHECKED_STEPS):
            stats = self._step()
            losses.append(stats["loss"].float())
            if i == 0:
                self.terms = {k: float(v) for k, v in stats.items()
                              if k != "loss"}
                named = [(n, opt.state[p]["exp_avg"] / (1 - opt.defaults[
                    "betas"][0])) for n, p in model.named_parameters()
                    if p in opt.state]
                self.grad = leaf_norms(named)
        now = dict(model.named_parameters()) | dict(stats_buffers(model))
        self.delta = leaf_norms([(k, v.detach().float()
                                  - self.theta0[k].to(v.device))
                                 for k, v in now.items()])
        self.loss = torch.stack(losses).cpu().tolist()

    def window(self, seconds: float) -> dict:
        dev = self.device
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        n0 = program.dcn_launches() if dev.type == "cuda" else 0
        sync()
        t_open = time.perf_counter()
        steps = 0
        while time.perf_counter() - t_open < seconds:
            self._step()
            steps += 1
        sync()
        span = time.perf_counter() - t_open
        if dev.type == "cuda":
            self.launches = (program.dcn_launches() - n0) / steps
        return {"attempted": steps, "failed": 0, "units": steps,
                "train_images_per_s": steps * self.traffic["batch"] / span}

    def traced(self):
        n = self.traffic["trace_steps"]
        for _ in range(n):
            self._step()
        return n

    def release(self):
        del self.state, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison with the plain reference --------------------------

    def reference(self, tf32_operands=False, half=False) -> dict:
        """The reference's readings of the first three steps: {"loss",
        "grad", "delta", "terms"}, in f32 with TF32 off.
        `tf32_operands`: with TF32's rounding emulated (the control where
        no card runs TF32); `half`: each step on the first half of its
        batch (a fault)."""
        conf, dev = self.conf, self.device
        task = cells.task(conf["task"])
        net = nets.build(conf).to(dev).train()
        net.load_state_dict(self.theta0)
        if tf32_operands:
            control.emulate_tf32(net)
        opt = adam.Adam(conf["train"]["lr"])
        losses = []
        with tf32.switch(False):
            for i in range(CHECKED_STEPS):
                batch = self.batches[i]
                if half:
                    batch = {k: v[:len(v) // 2] for k, v in batch.items()}
                for p in net.parameters():
                    p.grad = None
                outs = net(batch["input"].contiguous())
                outs = [{k: v.permute(0, 2, 3, 1).float()
                         for k, v in o.items()} for o in outs]
                value, terms = task.reference_loss(outs, batch, conf)
                value.backward()
                losses.append(value.detach())
                if i == 0:
                    first_terms = {k: float(v.detach())
                                   for k, v in terms.items()}
                    grad = leaf_norms([(n, p.grad) for n, p in
                                       net.named_parameters()
                                       if p.grad is not None])
                opt.step(net.named_parameters())
        now = dict(net.named_parameters()) | dict(stats_buffers(net))
        delta = leaf_norms([(k, v.detach().float()
                             - self.theta0[k].to(dev))
                            for k, v in now.items()])
        return {"loss": torch.stack(losses).cpu().tolist(), "grad": grad,
                "delta": delta, "terms": first_terms}

    def readings(self) -> dict:
        return {"loss": self.loss, "grad": self.grad, "delta": self.delta,
                "terms": self.terms}

    def check(self) -> dict:
        return compare(self.readings(), self.reference())


def compare(got: dict, ref: dict) -> dict:
    """The numbers of the module docstring from two sets of readings, and
    beside them (read, not compared) the first step's loss and its terms
    and the median leaf's gradient."""
    def rel(a, b):
        return abs(a - b) / abs(b)
    g_ref = ref["grad"]
    med = float(np.median(list(g_ref.values())))
    grad = [abs(got["grad"].get(k, 0.0) - v) / max(v, med)
            for k, v in g_ref.items()]
    moved = {k: v for k, v in ref["delta"].items()
             if k.endswith(("running_mean", "running_var"))
             or g_ref.get(k, 0.0) >= 1e-3 * med}
    med_d = float(np.median(list(moved.values())))
    upd = max(abs(got["delta"].get(k, 0.0) - v) / max(v, med_d)
              for k, v in moved.items())
    return {"loss_gap": max(rel(a, b) for a, b in zip(got["loss"],
                                                      ref["loss"])),
            "grad_norm_gap": float(max(grad)),
            "update_norm_gap": float(upd),
            "loss_gap.first": rel(got["loss"][0], ref["loss"][0]),
            "terms_gap.first": max(rel(got["terms"][k], v)
                                   for k, v in ref["terms"].items()),
            "grad_norm_gap.median": float(np.median(grad))}


def readings(cell: dict, seed: int, control_run: bool, seconds: float,
             device) -> dict:
    """The numbers of one seed's first three steps (benchmark/readings.py;
    `seconds` unused: training needs no window): of the program, or, with
    `control_run`, of the program with its TF32 path switched on, and
    beside it the reference with TF32's rounding emulated
    (`emulated_tf32`) and the fault "half of each batch left out"
    (`half_batch`), each against the reference."""
    drv = Driver(cell, seed, device)
    drv.tf32 = drv.tf32 or control_run
    drv.warm_up()
    got = drv.readings()
    drv.release()
    ref = drv.reference()
    out = compare(got, ref)
    if control_run:
        out["emulated_tf32"] = compare(drv.reference(tf32_operands=True),
                                       ref)
        out["half_batch"] = compare(drv.reference(half=True), ref)
    return out
