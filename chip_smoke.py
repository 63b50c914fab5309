#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and hold its CUDA
kernel against the plain PyTorch version.

    python3 chip_smoke.py

The main path is DLA-34 polydet inference on 2048x1024 Cityscapes frames
at full width (8 classes, 16 vertices, head_conv 256, 512x1024 network
input), seeded random weights, through `create_detector(...).run` and
`run_batch`.  Phases (any failure exits non-zero, with no result line):

  1. the card: nvidia-smi name and power limit, device name and count;
  2. build csrc/dcn_fwd.cu with nvcc (sm_90a) and print ptxas's report;
  3. the kernel against `deform_conv2d_ref` at the 7 DCN node shapes of
     the path, exact and rowband:6, f32 (TF32 off; relative max 1e-4: the
     same f32 arithmetic summed in another order) and bf16 (relative max
     2e-2: the plain version rounds the bilinear fractions and corner
     products to bf16, deform_conv.py:122, the kernel keeps them in f32);
  4. the slice: bf16 detector (the inference default rowband:6, then the
     exact `off` mode) on seeded frames, each path run with the launch
     counts zeroed just before and read just after (16 a forward); f32 on
     the card (TF32 off) against the port on the CPU, per head;
  5. times with CUDA events at each node shape (kernel, plain version,
     bound) and end to end per frame;
  6. device time by kernel and the device's busy share (torch.profiler).

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
# (H, W, Cin, Cout) of the 16 DCN nodes at 512x1024 input, stride 4, and
# how many nodes of each shape a frame runs
NODE_SHAPES = {(16, 32, 512, 256): 1, (32, 64, 256, 256): 1,
               (32, 64, 256, 128): 2, (64, 128, 128, 128): 2,
               (64, 128, 128, 64): 4, (32, 64, 256, 64): 1,
               (128, 256, 64, 64): 5}
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
FRAME_HW = (1024, 2048)
SOURCE = "centerpoly_tpu_torch/csrc/dcn_fwd.cu"
REPLACES = {"exact": "centerpoly_tpu/kernels/dcn_pallas.py:44",
            "rowband": "centerpoly_tpu/kernels/dcn_rowband.py:132"}


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, warmup: int, iters: int) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def node_inputs(shape, dtype, seed):
    """Seeded DCN node inputs on the card; offsets of std 4 px, so some
    y-offsets pass the rowband:6 band."""
    import torch
    h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, h, w, cin, generator=g)
    off = torch.randn(1, h, w, 18, generator=g) * 4.0
    mask = torch.sigmoid(torch.randn(1, h, w, 9, generator=g))
    wt = torch.randn(3, 3, cin, cout, generator=g) / (3 * cin ** 0.5)
    bias = torch.randn(cout, generator=g)
    dev = torch.device("cuda")
    return (x.to(dev, dtype), off.to(dev), mask.to(dev), wt.to(dev, dtype),
            bias.to(dev, dtype))


def node_bound_ms(shape) -> tuple[float, str]:
    """Least time for one bf16 node: operations over the bf16 peak against
    bytes (each input read once, the output written once) over HBM."""
    h, w, cin, cout = shape
    flops = 2.0 * h * w * 9 * cin * cout
    nbytes = (h * w * cin * 2 + h * w * 27 * 4 + 9 * cin * cout * 2
              + cout * 2 + h * w * cout * 2)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def random_state_dict(model, seed: int):
    """Seeded random weights, every entry non-degenerate.  The DCN offset
    convs are scaled to give y-offsets of up to ~20 px (some beyond the
    rowband:6 band): at the gain of the other convs they reach ~70 px on a
    2048x1024 frame and the network turns chaotic (f32 on the card then
    parts from f32 on the CPU by ~0.2 relative), so no comparison across
    implementations could hold."""
    import torch
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            continue
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            a = 0.5 + rng.rand(*shape)
        elif k.endswith("running_mean"):
            a = 0.05 * rng.randn(*shape)
        elif v.dim() == 1 and k.endswith("weight"):       # BN scale
            a = 0.75 + 0.5 * rng.rand(*shape)
        elif v.dim() == 1:                                # biases
            a = 0.05 * rng.randn(*shape)
        else:
            gain = 0.3 if "conv_offset_mask" in k else 1.2
            a = rng.randn(*shape) * gain / np.sqrt(np.prod(shape[1:]))
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def phase_card():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[card] {name} x{count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    return name, count


def phase_build():
    from centerpoly_tpu_torch.kernels import dcn
    t0 = time.perf_counter()
    path, log = dcn.build()
    print(f"[build] {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"[build] {line.strip()}")


def phase_kernel_vs_plain():
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {"exact": 0.0, "rowband": 0.0}
    for i, shape in enumerate(NODE_SHAPES):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = node_inputs(shape, dtype, SEED + i)
            for mode, r in (("exact", None), ("rowband", 6)):
                got = dcn.deform_conv2d(*args, max_offset_y=r)
                ref = dcn.deform_conv2d_ref(*args, max_offset_y=r)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs().max().item()
                rel = diff / ref.float().abs().max().item()
                print(f"[kernel] {shape} {mode:7s} {str(dtype)[6:]:8s} "
                      f"max_abs {diff:.3e} rel_max {rel:.3e} (tol {tol:g})")
                check(np.isfinite(rel) and rel < tol,
                      f"kernel disagrees at {shape} {mode} {dtype}")
                if dtype == torch.bfloat16:
                    errs[mode] = max(errs[mode], diff)
    return errs


def run_counted(fn, key):
    """Run one path with the launch counts zeroed just before and read
    just after."""
    from centerpoly_tpu_torch.kernels import dcn
    for k in dcn.launches:
        dcn.launches[k] = 0
    out = fn()
    counts = dict(dcn.launches)
    check(counts[key] == 16 and sum(counts.values()) == 16,
          f"expected 16 {key} launches, got {counts}")
    return out, counts[key]


def phase_slice():
    import torch
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.models.deform_conv import DCNv2

    cfg = Config(task="polydet", dataset="cityscapes", arch="dla_34")
    check(cfg.prefer_fast_inference_dcn() and cfg.dcn_kernel == "rowband:6",
          "inference default is not rowband:6")
    sd = random_state_dict(create_model(cfg.arch, cfg.heads, cfg.head_conv),
                           SEED)
    frames = [np.random.RandomState(SEED + i).randint(
        0, 256, (*FRAME_HW, 3), dtype=np.uint8) for i in range(4)]

    det = create_detector(cfg, sd)
    check(det.device.type == "cuda" and det.dtype == torch.bfloat16,
          f"detector on {det.device} in {det.dtype}")

    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(
            (*inp[0].shape[2:], inp[0].shape[1], out.shape[1])))
        for m in det.model.modules() if isinstance(m, DCNv2)]
    ret, launches_rowband = run_counted(lambda: det.run(frames[0]), "rowband")
    for h in hooks:
        h.remove()
    check(collections.Counter(shapes) == collections.Counter(NODE_SHAPES),
          f"DCN node shapes {collections.Counter(shapes)}")
    print(f"[slice] rowband:6 run: {launches_rowband} kernel launches, "
          f"node shapes as expected")
    for i, frame in enumerate(frames[1:3], 1):
        ret, n = run_counted(lambda: det.run(frame), "rowband")
        rows = np.concatenate([np.asarray(v) for v in ret["results"].values()])
        check(rows.shape == (cfg.K, 4 + 1 + 2 * cfg.nbr_points + 1)
              and np.isfinite(rows).all(), f"frame {i} results {rows.shape}")
        print(f"[slice] frame {i}: {n} launches, stages (ms) " + " ".join(
            f"{k} {1e3 * ret[k]:.2f}" for k in
            ("tot", "load", "pre", "net", "dec", "post", "merge")))
    batch, n = run_counted(lambda: det.run_batch(frames), "rowband")
    check(len(batch) == 4, "run_batch returned the wrong count")
    print(f"[slice] run_batch of 4: {n} launches (one batched forward)")

    with torch.no_grad():
        trans, meta = det._scaled_trans(*FRAME_HW, 1.0)
        images = det._pre_device(torch.from_numpy(frames[0]).cuda()[None],
                                 trans, (meta["inp_h"], meta["inp_w"]))
        dets = det._process_device(images)
    check(tuple(dets.shape) == (1, cfg.K, 6 + 2 * cfg.nbr_points + 1)
          and bool(torch.isfinite(dets).all()),
          f"decoded detections {tuple(dets.shape)} not finite/shaped")
    print(f"[slice] decoded detections {tuple(dets.shape)}, finite")

    cfg_exact = Config(dcn_kernel="off")
    det_exact = create_detector(cfg_exact, sd)
    _, launches_exact = run_counted(lambda: det_exact.run(frames[0]), "exact")
    print(f"[slice] exact (off) run: {launches_exact} kernel launches")

    # f32 on the card (TF32 off) against the port on the CPU (plain DCN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = Config(mixed_precision=False)
    cfg32.prefer_fast_inference_dcn()
    det32 = create_detector(cfg32, sd)
    det_cpu = create_detector(cfg32, sd, device="cpu")
    offs = []
    hooks = [m.conv_offset_mask.register_forward_hook(
        lambda mod, inp, out: offs.append(out[:, 0:18:2].abs().max().item()))
        for m in det32.model.modules() if isinstance(m, DCNv2)]
    with torch.no_grad():
        x_cpu = det_cpu._pre_device(torch.from_numpy(frames[0])[None], trans,
                                    (meta["inp_h"], meta["inp_w"]))
        ref = det_cpu._heads(x_cpu)
        got32 = det32._heads(x_cpu.to("cuda", memory_format=torch.channels_last))
        got16 = det._heads(x_cpu.to("cuda", torch.bfloat16,
                                    memory_format=torch.channels_last))
    for h in hooks:
        h.remove()
    print(f"[slice] max |y-offset| per DCN node (f32 card): "
          + " ".join(f"{o:.1f}" for o in offs))
    for k in ref:
        scale = ref[k].abs().max().item()
        r32 = (got32[k].float().cpu() - ref[k]).abs().max().item() / scale
        r16 = (got16[k].float().cpu() - ref[k]).abs().max().item() / scale
        print(f"[slice] head {k}: f32 card vs CPU rel_max {r32:.3e}; "
              f"bf16 card vs CPU rel_max {r16:.3e}")
        check(r32 < 2e-3, f"f32 head {k} disagrees with the CPU port")
        check(bool(torch.isfinite(got16[k]).all()), f"bf16 head {k} not finite")
    return det, frames, {"rowband": launches_rowband, "exact": launches_exact}


def phase_times(det, frames):
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    per_frame = {m: {"ms": 0.0, "plain_ms": 0.0} for m in ("exact", "rowband")}
    bound_frame, ops_share = 0.0, 0.0
    for i, (shape, n) in enumerate(NODE_SHAPES.items()):
        args = node_inputs(shape, torch.bfloat16, SEED + i)
        bound, by = node_bound_ms(shape)
        bound_frame += n * bound
        ops_share += n * bound * (by == "operations")
        for mode, r in (("exact", None), ("rowband", 6)):
            ms = cuda_ms(lambda: dcn.deform_conv2d(*args, max_offset_y=r), 3, 20)
            plain = cuda_ms(lambda: dcn.deform_conv2d_ref(*args, max_offset_y=r),
                            1, 5)
            per_frame[mode]["ms"] += n * ms
            per_frame[mode]["plain_ms"] += n * plain
            print(f"[time] {shape} x{n} {mode:7s} kernel {ms:.4f} ms  plain "
                  f"{plain:.4f} ms  bound {bound:.4f} ms ({by})  "
                  f"{2 * np.prod(shape[:2]) * 9 * shape[2] * shape[3] / ms / 1e9:.1f}"
                  f" TFLOP/s")
    for mode, v in per_frame.items():
        print(f"[time] {mode} per frame (16 nodes): kernel {v['ms']:.3f} ms  "
              f"plain {v['plain_ms']:.3f} ms  bound {bound_frame:.4f} ms")

    tots = []
    for i in range(12):
        ret = det.run(frames[i % len(frames)])
        if i >= 2:
            tots.append(ret["tot"])
    p50 = 1e3 * statistics.median(tots)
    print(f"[e2e] run: p50 {p50:.2f} ms/frame, mean {1e3 * statistics.mean(tots):.2f}"
          f" ms, {len(tots) / sum(tots):.2f} frames/s (10 frames, bf16, rowband:6)")
    det.run_batch(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        det.run_batch(frames)
    dt = (time.perf_counter() - t0) / 3
    print(f"[e2e] run_batch of 4: {1e3 * dt / 4:.2f} ms/frame, "
          f"{4 / dt:.2f} frames/s")
    by = "operations" if ops_share >= bound_frame / 2 else "bytes"
    return per_frame, bound_frame, by


def phase_profile(det, frames):
    """Device time by kernel over 3 `run` calls, and the device's busy
    share of their wall time (one stream, so kernel times do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frame in frames[:3]:
            det.run(frame)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print("[profile] no device time in the trace: busy share not measured")
        return
    dcn_ms = sum(r[0] for r in rows if "dcn_fwd" in r[2])
    print(f"[profile] 3 frames: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f} %), DCN kernel {dcn_ms:.2f} ms "
          f"({100 * dcn_ms / busy:.1f} % of device time)")
    for ms, n, key in rows[:12]:
        print(f"[profile] {ms / 3:8.3f} ms/frame  {n // 3:4d} calls/frame  {key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    name, count = phase_card()
    phase_build()
    errs = phase_kernel_vs_plain()
    det, frames, launches = phase_slice()
    per_frame, bound_frame, by = phase_times(det, frames)
    phase_profile(det, frames)
    kernels = [{"name": f"dcn_fwd[{mode}]", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[mode], "launches": launches[mode],
                "max_abs_err": errs[mode], "ms": per_frame[mode]["ms"],
                "plain_ms": per_frame[mode]["plain_ms"],
                "bound_ms": bound_frame, "bound_by": by, "library_ms": None}
               for mode in ("exact", "rowband")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
