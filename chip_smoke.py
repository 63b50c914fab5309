#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA H100 and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

The main paths are DLA-34 polydet inference on 2048x1024 Cityscapes frames
at full width (8 classes, 16 vertices, head_conv 256, 512x1024 network
input), seeded random weights, through `create_detector(...).run`,
`run_batch` and `run_stream`, and the demo, video and CSV entry points
beside them; and polydet training at the same width
through `centerpoly_tpu_torch.main` on a synthetic 2048x1024 fixture
(batch 4, f32, the paper's v2 loss); each in the DCN modes `off` (exact),
`rowband:R` and `halo:4`.  Then the same two paths on smallhourglass and
Hourglass-104 (2 stacks), pure convolution: no DCNv2 node, so no kernel
of csrc/ runs there; and on resdcn_18 and resdcn_101, whose 3 DCNv2
nodes a forward run the same kernels (resdcn_101's first at Cin 2048),
with res_18, res_101 and dlav0_34 (no DCNv2 node) beside them.  Last,
the ctdet task (box detection, COCO's 80 classes at 512x512) on DLA-34:
`create_detector`, `main`, `test.py` and its three evaluators; the exdet,
multi_pose and ddd (3D boxes on KITTI) tasks the same way; the
on-device NMS and the pixel-level semantic evaluator; and the remaining
modules: the experimental losses' device half, the sampler's auxiliary
targets and the host tools.  Phases
(any failure exits non-zero, with no result line):

  1. the card: nvidia-smi name and power limit, device name and count;
  2. build csrc/dcn_fwd.cu and csrc/dcn_bwd.cu with nvcc (sm_90a), one
     process each, and print ptxas's report;
  3. the forward kernel against `deform_conv2d_ref` at the 7 DCN node
     shapes of the path, at resdcn_101's (16, 32, 2048, 256) node (batch
     1 and 4) and at the card tests' tile shapes (split K, one
     pixel, Cout 300, f32 at batch 4), exact, rowband:6 and halo:4, f32
     (TF32 off; relative max 1e-4: the kernel's 3xTF32 products keep f32
     accuracy, summed in another order) and bf16 (relative max 2e-2: the
     plain version rounds the bilinear fractions and corner products to
     bf16, deform_conv.py:122, the kernel blends in f32 and rounds the
     modulated sample once); then two calls bit-equal, split and unsplit;
  4. the slice: bf16 detector (the inference default rowband:6, then the
     exact `off` mode) on seeded frames, each path run with the launch
     counts zeroed just before and read just after (16 a forward); f32 on
     the card (TF32 off) against the port on the CPU, per head;
  5. the slice in halo:4: `run` and `run_batch` (16 halo launches a
     forward, none of another mode), `run_stream` equal to `run` frame by
     frame, f32 heads on the card against the CPU, and
     `tools/analyze_dcn_offsets` on the same weights and frame, whose
     clamp must bite (`phase_halo_slice`);
  6. times with CUDA events at each node shape (kernel calls replayed
     from a CUDA graph, i.e. device time, and eager; plain version,
     bound, share of the bound, TFLOP/s, K splits; a dense 3x3 cuDNN conv
     of the same shape beside it for context) in the three modes, the f32
     batch-4 forward of a train step per node and per step against its
     TF32 bound, and end to end per frame (`run`, `run_batch`,
     `run_stream`);
  7. device time by kernel and the device's busy share (torch.profiler),
     and the busy share of `run` and `run_stream` in halo:4;
  8. csrc/dcn_bwd.cu against the plain backward at the 7 node shapes,
     batch 2 (batch 4 in phase 10), at resdcn_101's 2048-channel node,
     batch 1 and 4, and at the card tests' tile shapes (one pixel, Cout 300,
     Cin 3 / Cout 5, many dW splits), exact, rowband:4 and halo:4, f32 and
     bf16; two calls bit-equal but for dx; offsets at +-R on each axis,
     beyond R and all zero (tolerances and tie rules in
     `phase_bwd_vs_plain`);
  9. the training slice: `main` for one epoch of 2 steps in `off`,
     rowband:4 and halo:4 (16 forward + 16 backward launches a step), the
     loss falling on one fixed batch, a checkpoint round trip, and one f32
     step on the card against the port on the CPU (`phase_train_vs_cpu`);
 10. the backward as a train step runs it (f32, batch 4) per node and per
     step in the three modes: against the plain backward (phase 8's f32
     tolerances), then device time by CUDA graph replay (the kernels
     line's `ms`) beside the eager wrapper's, the plain version's, its
     bound on the TF32 basis (`bound_ms`) and on the f32 CUDA cores, the
     time of each of its kernels (profiler), and for context v1's two f32
     cuBLAS GEMMs at each node's shape; train step p50, images/s and peak
     memory per mode, the loader's host time, one profiled step in `off`
     and in halo:4;
 11. smallhourglass inference at full width, bf16 (`phase_hourglass_infer`):
     `run`, `run_batch` of 4 and `run_stream` on phase 4's frames with 0
     DCN launches, f32 heads on the card against the CPU, times, the
     device's busy share of `run`;
 12. smallhourglass and Hourglass-104 training through `main` (batch 4,
     512x1024, f32), 0 DCN launches, the loss falling, a checkpoint round
     trip and `train_vs_cpu` for smallhourglass, step p50, images/s, peak
     memory and one profiled step for both (`phase_hourglass_train`);
 13. the polygon instance-AP eval path (`phase_eval`) on a PNG fixture of
     4 Cityscapes-named 2048x1024 val frames written by the port's
     encoder: `main` for one epoch (batch 4, 512x1024, f32, `off`) with
     `--val_intervals 1` and all four `--eval_oracle_*` flags, whose AP
     must pass 0.5, gate model_best, and equal to the last digit what
     `_decode_outputs` and `run_eval` give on the CPU for the same val
     batches with zero heads; then `python -m centerpoly_tpu_torch.test`
     (bf16, rowband:6) on that model_best with `--eval_batch` 1 and 4, 16
     rowband launches a forward; the host times of the rasterizer, the
     PNG codec, the matcher and `run_eval`; the two runs' results agree
     (`results_agree`); and test.py's frames/s once warm (`eval_rates`);
 14. data parallelism (`phase_data_parallel`): (a) two ranks spawned on the
     one card, over gloo (NCCL refuses two ranks on one device: a choice of
     this harness, not the library's rule), run the global-batch step as
     `Trainer` builds it (DDP, global BatchNorm statistics and loss
     denominators), each on 2 samples of a global batch of 4 at 512x1024,
     f32, `off`, TF32 off, against the one-process batch-4 step on the
     card: loss rtol 1e-4; every gradient within 4x the one-process
     step's own move under a seeded 1e-6 weight change (+1e-3) in
     relative L2 (phase 9's rule for an ill-conditioned random net);
     BatchNorm statistics within 1e-3 relative max; gradients, parameters
     and statistics equal on both ranks; the parameters after Adam within
     2 lr + 1e-6 beside them (Adam's first step moves a weight by ~lr
     whatever the gradient: a sanity check); the same for the bucketed
     step (`grad_bucket`) on a batch that tiles one sample; 16 `dcn_fwd` + 16 `dcn_bwd` launches
     a rank a step (counts zeroed just before, read just after, in each
     rank), step p50 and peak memory a rank; (b) with two or four cards,
     `main` over NCCL with one process a card and test.py
     `--infer_devices 2`, else one line saying it did not run; (c)
     `run_batch` of 4 frames (bf16, rowband:6) over `[cuda:0, cuda:0]`,
     two replicas on one card: 32 rowband launches (16 a replica); the
     detections of one replica at the same batch of 2 (scores within
     1e-3, box and vertices within 1 px), and of one replica's batch of 4
     within `results_agree`'s bounds (bf16 at another batch runs other
     convolution algorithms and DCN splits: 2.4e-3 in score measured);
 15. resdcn_18 at full width (`phase_resdcn18`; before it,
     `phase_resdcn_node_times` times both kernels at resdcn_101's
     2048-channel node): a 2048x1024 uint8 frame, K=128, bf16, rowband:6,
     `run` and `run_batch` with 3 `dcn_fwd` launches a forward (counts
     zeroed just before, read just after), `run` p50, the device's busy
     share of `run` by kind; f32 heads on the
     card against the CPU port (relative max < 2e-3); `main --arch
     resdcn_18` for one epoch on the phase 9 fixture (batch 4, f32, `off`,
     3 + 3 launches a step), the loss falling, one more step with the
     counts zeroed just before and read just after (the kernels line's
     `resdcn18_train_step_launches`), step p50, peak memory and one
     profiled step; `train_vs_cpu` in `off`;
 16. resdcn_101 (`phase_resdcn101`, random weights at RES101_GAIN): one
     f32 forward on the card against the CPU port (3 launches), `main
     --arch resdcn_101` for an epoch of 2 steps at batch 4, one counted
     step, its step p50, peak memory and one profiled step; then res_18,
     res_101 and dlav0_34, one f32 forward each against the CPU port, no
     DCN launch;
 17. the image demo and the video loops (`phase_demo`), DLA-34 bf16
     rowband:6 on phase 4's weights: `infer/demo.py` main on a 2048x1024
     PNG with --save_overlay and --debug 4 (16 launches; the overlay,
     detections.png and pred_hm.png read back), the host time of
     `_debug_views`, and `run_video`'s three loops (per frame, batched by
     4, pipelined) over an in-memory capture of 8 seeded frames, each
     frame's results against `run`'s, and each loop's frames/s;
 18. `infer/run_on_csv.py` (`phase_run_on_csv`) over 6 PNG frames at
     2048x1024 and 2 at 1242x375, --eval_batch 1 and 4 (the flush on the
     change of shape), bf16 and f32, 16 rowband launches a frame, the rows
     of the two batch sizes held together, and frames/s;
 19. the oracle-free convergence harness (`phase_convergence`,
     tools/train_convergence.py): the kernels against their plain
     versions at the dla_34 run's node shapes (128x256 input, batch 4,
     f32); res_18 to AP50 >= 0.5 and AP > 0.15; dla_34 (exact forward and
     backward kernels in every step) to AP50 >= 0.5, its AP50 under
     rowband:4 on the same weights and the learned offsets' saturation at
     R = 4, that run's launches counted by stage (16 + 16 a train step, 16
     a val batch, 16 rowband a re-score batch, 16 for the offsets);
 20. the ctdet task (`phase_ctdet`) on COCO's DLA-34 at full width (80
     classes, head_conv 256, 512x512 input; hm 80, wh 2, reg 2), seeded
     random weights: (a) both kernels against their plain versions at
     the distinct DCN node shapes of a 512x512 and a 384x1280 (KITTI)
     input, the forward in bf16 at batch 1 and f32 at batch 4 in exact /
     rowband:6 / halo:4, the backward in f32 at batch 4 in exact /
     rowband:4 / halo:4 (phases 3 and 8's bounds), and the forward's time
     over a frame's 16 nodes at each input (bf16, batch 1); (b) `create_detector` (bf16,
     rowband:6) on a seeded COCO-format box fixture's 480x640 val frames:
     16 launches a frame, `run_batch`, `run_stream` equal to `run`, run
     p50 and frames/s, f32 heads card vs CPU; (c) `main ctdet` (batch 4,
     512x512, f32, `off`) with validation: coco_eval.json, one counted
     step (16 + 16), step p50, test.py's AP equal to main's, and
     `train_vs_cpu` of a ctdet step; (d) (b)'s detections scored by
     `PascalMeta.run_eval` (VOC-07 and the COCO-protocol file) and, as
     KITTI-2D rows, by the native `run_kitti_eval`, built from cpp/ at
     first use;
 21. the exdet task (`phase_task("exdet")`) on COCO's DLA-34 at full width
     (heads hm_t / hm_l / hm_b / hm_r / hm_c 80 each, reg_t / reg_l /
     reg_b / reg_r 2 each; head_conv 256, 512x512), seeded random weights,
     on a COCO box fixture with extreme points (480x640 frames): (a)
     `create_detector` (bf16, rowband:6): 16 launches a frame, also under
     flip_test (flip_tta off: a batch of 1, the plain run's results),
     `run_batch`, `run_stream` equal to `run`, run p50 and frames/s,
     `exct_decode`'s own device ms and memory at k 40 (batch 1 and 4), f32
     heads and the best result rows card vs CPU (also with agnostic_ex,
     whose random weights give rows); (b) `main exdet` (batch
     4, 512x512, f32, `off`) with validation on the val loss, one counted
     step (16 + 16), step p50, test.py writing coco_eval.json, and
     `train_vs_cpu` of an exdet step;
 22. the multi_pose task (`phase_task("multi_pose")`) on COCO-HP's
     DLA-34 at full width (hm 1, wh 2, hps 34, hm_hp 17, hp_offset 2, reg
     2), on a COCO keypoints fixture: as phase 21, with flip_test's
     doubled batch (16 launches, the best rows equal to the CPU's flip
     run), test.py scoring the 39-column rows through CocoHpMeta, and a
     step of `main multi_pose --aug_rot 1 --rotate 30` (finite; the
     loader's host ms a batch beside the unrotated one's);
 23. the ddd task (`phase_ddd`) on KITTI's DLA-34 at full width (3
     classes, head_conv 256, 384x1280 input; hm 3, dep 1, rot 8, dim 3,
     wh 2, reg 2), seeded random weights, on a seeded KITTI 3D fixture
     (`write_kitti3d_fixture`: 8 train and 4 val 1242x375 PNG frames):
     (a) f32 heads on the card within 2e-3 of the CPU port and two
     frames' best rows card vs CPU; (b) `create_detector` (bf16,
     rowband:6): 16 launches a frame, also under flip_test (a batch of 1,
     the plain results), `run_batch` of 4 (16), `run_stream` equal to
     `run`, run p50 and frames/s, `ddd_decode`'s own device ms; (c) `main
     ddd` (batch 4, 384x1280, f32, `off`) with validation on the val
     loss, one counted step (16 + 16), step p50, images/s and peak
     memory, the loader's host ms a batch with aug_ddd 0 and 1; (d)
     test.py on (a)'s weights (f32) on the card and on the CPU through
     KittiMeta and the native `kitti_eval` built here, their rows
     agreeing, and a 40-frame fixture's GT as results scoring AP 100 in
     detection, BEV and 3D;
 24. `soft_nms_batch` and `hard_nms_batch` on the card at K 128 against
     the host `soft_nms`, a greedy reference and the CPU, with their
     device ms; `evaluate_semantic` over two 1024x2048 label maps, the
     native confusion loop built here against its numpy path;
 25. the remaining modules (`phase_remaining`): (a) the experimental
     losses' device half, `disk_loss_device` and `area_poly_loss_device`
     in each rep at B 4, K 128 (32 valid), 128x256, N 16: f32 forward +
     backward ms and peak memory on the card, and in f64 the card against
     the port on the CPU (loss within 1e-4 relative, the gradient of pred
     within 1e-4 of its largest); (b) the polydet sampler at 512x1024
     over phase 9's fixture (default, --cat_spec_poly, --dense_poly: host
     ms a batch of 4), the extra host ms of reading fg from a 16-bit
     gtFine_instanceIds PNG beside phase 13's PNG frames (filter None
     and Paeth), and one DLA-34 `off` train step on such a batch with its
     launches counted (16 + 16); (c) the host tools: polygon GT jsons
     from phase 13's 16-bit val GT, `gt_polygons.main`, `csv_to_coco`,
     `coco_poly_to_polar`, `polygon_coverage`, `simplify_masks` and
     `visualize_results`, host seconds of each.  PIL, cv2 and matplotlib
     are made unimportable for the whole phase.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --bwd-times

runs phases 1, 2 and the backward's times of phase 10 only, with no check
and no result line: run in a tree and in a variant of it (another split
rule, a kernel with a part compiled out) within one card call, it
compares the two.
"""
from __future__ import annotations

import collections
import datetime
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
# the 3 DCN nodes of resdcn_18 and resdcn_101 at the same input (one before
# each deconv stage, resnet_dcn.py): the first reads the trunk's stride-32
# output, 512 channels wide in ResNet-18 and 2048 in ResNet-101 (4x the
# input width of DLA-34's widest node)
RESDCN101_NODE = (16, 32, 2048, 256)
RESDCN_NODES = {"resdcn_18": [(16, 32, 512, 256), (32, 64, 256, 128),
                              (64, 128, 128, 64)],
                "resdcn_101": [RESDCN101_NODE, (32, 64, 256, 128),
                               (64, 128, 128, 64)]}
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12    # H100 SXM dense TF32 (the f32 forward's 3xTF32)
PEAK_F32_FLOPS = 67e12      # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
FRAME_HW = (1024, 2048)
# device kernels by kind, from their names: cuDNN / CUTLASS convolutions,
# BatchNorm (statistics, transform, backward), copies and uploads, Adam's
# fused multi-tensor kernels
PROFILE_KINDS = {"convolution": ("implicit_gemm", "fprop", "dgrad", "wgrad",
                                 "cudnn::cnn", "cutlass"),
                 "batchnorm": ("batch_norm", "batchnorm", "Welford"),
                 "copy": ("Memcpy", "direct_copy", "Memset"),
                 "adam": ("multi_tensor", "Adam", "adam")}
# conv gain of the random hourglass weights: heads within a few units (at
# 1.2 the ~100 convolutions of a stack take the logits to ~300, where the
# heat map's sigmoid is exactly 1 at many peaks)
HG_GAIN = 0.8
# conv gain of the random ResNet-101 weights (res_101, resdcn_101): at 1.2
# the 33 bottlenecks take the trunk's output to ~5e4 and the heads to
# ~1e4, where a head's error relative to its own maximum leaves most of
# the map unchecked; at 0.9 the trunk's output stays within ~20 and the
# heads within ~1 (measured on the CPU at 256x512)
RES101_GAIN = 0.9
SOURCES = {"dcn_fwd": "centerpoly_tpu_torch/csrc/dcn_fwd.cu",
           "dcn_bwd": "centerpoly_tpu_torch/csrc/dcn_bwd.cu"}
REPLACES = {"dcn_fwd[exact]": "centerpoly_tpu/kernels/dcn_pallas.py:44",
            "dcn_fwd[rowband]": "centerpoly_tpu/kernels/dcn_rowband.py:132",
            "dcn_fwd[halo]": "centerpoly_tpu/kernels/dcn_halo.py:124",
            # the exact mode's backward is XLA autodiff in the JAX package
            "dcn_bwd[exact]": "centerpoly_tpu/models/deform_conv.py:744",
            "dcn_bwd[rowband]": "centerpoly_tpu/kernels/dcn_rowband.py:190",
            "dcn_bwd[halo]": "centerpoly_tpu/kernels/dcn_halo.py:173,231"}
# the training slice: rowband R, batch, and the flags of the paper's v2
# run (polar polygons, L1 + IoU polygon loss, vertex order loss)
TRAIN_R = 4
TRAIN_BATCH = 4
# halo R of both slices: kernels/dcn_halo.py DEFAULT_MAX_OFFSET
HALO_R = 4
TRAIN_MODES = {"exact": "off", "rowband": f"rowband:{TRAIN_R}",
               "halo": f"halo:{HALO_R}"}
# the kernels' clamp keywords by mode: the forward as inference runs it,
# the backward as training does
FWD_CLAMPS = {"exact": {}, "rowband": {"max_offset_y": 6},
              "halo": {"max_offset": HALO_R}}
BWD_CLAMPS = {"exact": {}, "rowband": {"max_offset_y": TRAIN_R},
              "halo": {"max_offset": HALO_R}}
TRAIN_FLAGS = ["--rep", "polar", "--poly_loss", "l1+iou", "--poly_order",
               "--lr", "2e-4"]
BWD_NAMES = ("dx", "doffsets", "dmasks", "dweights", "dbias")
# the forward's tile cases of tests/test_torch_gpu.py, (B, H, W, Cin, Cout):
# split K, one pixel, two channel tiles (the second ragged), f32 at batch 4
TILE_CASES = {(1, 16, 32, 512, 256): ("float32", "bfloat16"),
              (1, 1, 1, 64, 64): ("float32", "bfloat16"),
              (1, 8, 8, 40, 300): ("float32", "bfloat16"),
              (4, 64, 128, 128, 64): ("float32",)}
# the backward's tile cases of tests/test_torch_gpu.py: one pixel (offsets
# of std 0.5 px, so some corners land on it), Cout 300 (two dW tiles and
# two g slabs, the second ragged), Cin 3 / Cout 5, and dW split over many
# pixel ranges (f32 at batch 4)
BWD_TILE_CASES = {(1, 1, 1, 64, 64): ("float32", "bfloat16"),
                  (1, 8, 8, 40, 300): ("float32", "bfloat16"),
                  (2, 9, 13, 3, 5): ("float32", "bfloat16"),
                  (4, 64, 128, 128, 64): ("float32",)}


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


def graph_ms(fn, iters: int) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed between two CUDA events, so the host's time to enqueue each
    call (Python, the wrapper's checks and allocations) leaves no gap on
    the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mode_times(kernel, plain, clamps, iters, plain_iters, eager=None):
    """Device ms of one call in each clamp mode: `kernel(**kw)` by CUDA
    graph replay of `iters` calls, its eager call by CUDA events where
    `eager` = (warm-up calls, timed calls) is given, and `plain(**kw)` by
    CUDA events (1 warm-up, `plain_iters` timed).  Returns {mode: {"ms",
    "plain_ms"[, "eager_ms"]}}."""
    out = {}
    for mode, kw in clamps.items():
        t = {"ms": graph_ms(lambda: kernel(**kw), iters)}
        if eager:
            t["eager_ms"] = cuda_ms(lambda: kernel(**kw), *eager)
        t["plain_ms"] = cuda_ms(lambda: plain(**kw), 1, plain_iters)
        out[mode] = t
    return out


def fwd_fns(args):
    """(kernel, plain) forward calls of a node's inputs, taking the clamp
    keywords."""
    from centerpoly_tpu_torch.kernels import dcn
    return (lambda **kw: dcn.deform_conv2d(*args, **kw),
            lambda **kw: dcn.deform_conv2d_ref(*args, **kw))


def bwd_fns(args, g):
    """(kernel, plain) backward calls of a node's inputs and output
    gradient, taking the clamp keywords."""
    from centerpoly_tpu_torch.kernels import dcn
    return (lambda **kw: dcn.deform_conv2d_backward(*args, g, **kw),
            lambda **kw: dcn.deform_conv2d_backward_ref(*args, g, **kw))


def node_inputs(shape, dtype, seed, batch=1, scale=4.0):
    """Seeded DCN node inputs on the card; offsets of std `scale` px (4:
    some y-offsets pass the rowband:6 band)."""
    import torch
    h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, h, w, cin, generator=g)
    off = torch.randn(batch, h, w, 18, generator=g) * scale
    mask = torch.sigmoid(torch.randn(batch, h, w, 9, generator=g))
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


def random_state_dict(model, seed: int, gain: float = 1.2):
    """Seeded random weights, every entry non-degenerate; conv kernels at
    `gain` / sqrt(fan_in).  The DCN offset convs are scaled to give
    y-offsets of up to ~20 px (some beyond the rowband:6 band): at the gain
    of the other convs they reach ~70 px on a 2048x1024 frame and the
    network turns chaotic (f32 on the card then parts from f32 on the CPU
    by ~0.2 relative), so no comparison across implementations could
    hold."""
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
            g = 0.3 if "conv_offset_mask" in k else gain
            a = rng.randn(*shape) * g / np.sqrt(np.prod(shape[1:]))
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def phase_card():
    """Returns (device name, device count, nvidia-smi's name and power
    limit line)."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[card] {name} x{count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    return name, count, card


def phase_build():
    """Build every csrc/ source (one nvcc each, started together)."""
    from centerpoly_tpu_torch.kernels import dcn
    t0 = time.perf_counter()
    built = dcn.build()
    print(f"[build] {', '.join(os.path.relpath(p) for p, _ in built.values())}"
          f" in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            # registers of each instance, and any instance that spills
            if (("ptxas" in line and "Used" in line)
                    or ("spill" in line and ", 0 bytes spill stores" not in line)):
                print(f"[build] {name}: {line.strip()}")


def fwd_splits(shape, batch, dtype) -> int:
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    h, w, cin, cout = shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return dcn.fwd_plan(batch * h * w, cin, cout, n_sm, dtype).splits


def phase_kernel_vs_plain():
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    torch.backends.cuda.matmul.allow_tf32 = False
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    cases = [(shape, 1, dtype) for shape in NODE_SHAPES for dtype in tols]
    # resdcn_101's first node: batch 1 (inference) and 4 (training)
    cases += [(RESDCN101_NODE, b, dtype) for b in (1, TRAIN_BATCH)
              for dtype in tols]
    cases += [(shape[1:], shape[0], getattr(torch, dt))
              for shape, dts in TILE_CASES.items() for dt in dts]
    errs = dict.fromkeys(FWD_CLAMPS, 0.0)
    for i, (shape, batch, dtype) in enumerate(cases):
        tol = tols[dtype]
        args = node_inputs(shape, dtype, SEED + i, batch)
        for mode, kw in FWD_CLAMPS.items():
            got = dcn.deform_conv2d(*args, **kw)
            ref = dcn.deform_conv2d_ref(*args, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            rel = diff / ref.float().abs().max().item()
            print(f"[kernel] b{batch} {shape} {mode:7s} {str(dtype)[6:]:8s} "
                  f"splits {fwd_splits(shape, batch, dtype):2d} max_abs "
                  f"{diff:.3e} rel_max {rel:.3e} (tol {tol:g})")
            check(np.isfinite(rel) and rel < tol,
                  f"kernel disagrees at b{batch} {shape} {mode} {dtype}")
            if dtype == torch.bfloat16 and batch == 1 and (
                    shape in NODE_SHAPES or shape == RESDCN101_NODE):
                errs[mode] = max(errs[mode], diff)
        del args
    # determinism: split K (16x32) and unsplit (128x256), both types
    for shape in ((16, 32, 512, 256), (128, 256, 64, 64)):
        for dtype in tols:
            args = node_inputs(shape, dtype, SEED)
            first = dcn.deform_conv2d(*args, **FWD_CLAMPS["halo"])
            second = dcn.deform_conv2d(*args, **FWD_CLAMPS["halo"])
            torch.cuda.synchronize()
            check(torch.equal(first, second),
                  f"two calls differ at {shape} {dtype}")
            print(f"[kernel] {shape} {str(dtype)[6:]:8s} splits "
                  f"{fwd_splits(shape, 1, dtype)}: two calls bit-equal")
    return errs


def run_counted(fn, key, nodes=16):
    """Run one path with the launch counts zeroed just before and read
    just after: one `key` launch a DCN node of the net (DLA-34 16,
    resdcn 3), none of another kind."""
    from centerpoly_tpu_torch.kernels import dcn
    zero_counts()
    out = fn()
    counts = dict(dcn.launches)
    check(counts[key] == nodes and sum(counts.values()) == nodes,
          f"expected {nodes} {key} launches, got {counts}")
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
    check_heads("slice", ref, got32, got16)
    return det, sd, frames, {"rowband": launches_rowband,
                             "exact": launches_exact}


def check_heads(tag, ref, got32, got16=None):
    """f32 heads on the card within 2e-3 relative max of the CPU port's;
    bf16 heads, where given, finite."""
    import torch
    for k in ref:
        scale = ref[k].abs().max().item()
        r32 = (got32[k].float().cpu() - ref[k]).abs().max().item() / scale
        line = (f"[{tag}] head {k}: f32 card vs CPU rel_max {r32:.3e} (max "
                f"|head| {scale:.2f})")
        if got16 is not None:
            r16 = (got16[k].float().cpu() - ref[k]).abs().max().item() / scale
            line += f"; bf16 card vs CPU rel_max {r16:.3e}"
            check(bool(torch.isfinite(got16[k]).all()),
                  f"bf16 head {k} not finite ({tag})")
        print(line)
        check(np.isfinite(r32) and r32 < 2e-3,
              f"f32 head {k} disagrees with the CPU port ({tag})")


def phase_halo_slice(sd, frames, root):
    """The inference slice in halo:4, bf16: `run` on each seeded frame and
    `run_batch` of 4, each with the launch counts zeroed just before and
    read just after (16 halo launches a forward, none of another mode);
    `run_stream` over the 4 frames (depth 2), whose results must equal
    `run`'s frame by frame (cuDNN held to its deterministic algorithms for
    both, so the two are bitwise comparable); f32 heads on the card
    against the port on the CPU; and `tools/analyze_dcn_offsets` through
    its entry point on the same weights (as a .pth) and frame, which must
    find offsets beyond R on some node."""
    import torch
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.tools import analyze_dcn_offsets

    cfg = Config(dcn_kernel=f"halo:{HALO_R}")
    check(not cfg.prefer_fast_inference_dcn()
          and cfg.dcn_kernel == f"halo:{HALO_R}", "halo:4 was overridden")
    det = create_detector(cfg, sd)
    check(det.device.type == "cuda" and det.dtype == torch.bfloat16,
          f"detector on {det.device} in {det.dtype}")
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    for i, frame in enumerate(frames):
        ret, n = run_counted(lambda: det.run(frame), "halo")
        runs.append(ret["results"])
        rows = np.concatenate([np.asarray(v) for v in ret["results"].values()])
        check(rows.shape == (cfg.K, 4 + 1 + 2 * cfg.nbr_points + 1)
              and np.isfinite(rows).all(), f"halo frame {i} results")
    print(f"[halo] run: {n} halo kernel launches a frame, none of another "
          f"mode; results finite, {cfg.K} rows")
    batch, n = run_counted(lambda: det.run_batch(frames), "halo")
    check(len(batch) == len(frames), "run_batch returned the wrong count")
    print(f"[halo] run_batch of {len(frames)}: {n} launches (one batched "
          f"forward)")
    zero_counts()
    streamed = list(det.run_stream(iter(frames), depth=2))
    counts = dict(dcn.launches)
    torch.backends.cudnn.deterministic = flags
    check(counts["halo"] == 16 * len(frames)
          and sum(counts.values()) == counts["halo"],
          f"run_stream launches {counts}")
    check(len(streamed) == len(frames), "run_stream dropped frames")
    for i, (got, ref) in enumerate(zip(streamed, runs)):
        check(set(got) == set(ref) and all(
            np.array_equal(np.asarray(got[j]), np.asarray(ref[j]))
            for j in ref), f"run_stream frame {i} differs from run()")
    print(f"[halo] run_stream (depth 2) over {len(frames)} frames: "
          f"{counts['halo']} launches, each frame's results equal run()'s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = Config(mixed_precision=False, dcn_kernel=f"halo:{HALO_R}")
    det32 = create_detector(cfg32, sd)
    det_cpu = create_detector(cfg32, sd, device="cpu")
    trans, meta = det._scaled_trans(*FRAME_HW, 1.0)
    with torch.no_grad():
        x_cpu = det_cpu._pre_device(torch.from_numpy(frames[0])[None], trans,
                                    (meta["inp_h"], meta["inp_w"]))
        ref = det_cpu._heads(x_cpu)
        got32 = det32._heads(x_cpu.to("cuda",
                                      memory_format=torch.channels_last))
        got16 = det._heads(x_cpu.to("cuda", torch.bfloat16,
                                    memory_format=torch.channels_last))
    check_heads("halo", ref, got32, got16)
    del det32, det_cpu

    weights = os.path.join(root, "halo_weights.pth")
    torch.save({"state_dict": sd}, weights)
    np.save(os.path.join(root, "frame0.npy"), frames[0])
    rows = analyze_dcn_offsets.main([
        "polydet", "--load_model", weights, "--demo",
        os.path.join(root, "frame0.npy"), "--r", str(HALO_R),
        "--dcn_kernel", f"halo:{HALO_R}"])
    worst = max(rows, key=lambda row: row["xy_frac_clamped_at_r"])
    check(len(rows) == 16 and worst["xy_frac_clamped_at_r"] > 0,
          "analyze_dcn_offsets found no offset beyond R")
    print(f"[halo] analyze_dcn_offsets: {len(rows)} nodes, worst "
          f"{worst['node']} xy_frac_clamped_at_r "
          f"{worst['xy_frac_clamped_at_r']} (y_max {worst['y_max']}, x_max "
          f"{worst['x_max']})")
    return det, counts["halo"] // len(frames)


def phase_times(det, det_halo, frames):
    import torch
    import torch.nn.functional as F
    per_frame = {m: {"ms": 0.0, "plain_ms": 0.0} for m in FWD_CLAMPS}
    bound_frame, ops_share, conv_frame = 0.0, 0.0, 0.0
    for i, (shape, n) in enumerate(NODE_SHAPES.items()):
        args = node_inputs(shape, torch.bfloat16, SEED + i)
        bound, by = node_bound_ms(shape)
        bound_frame += n * bound
        ops_share += n * bound * (by == "operations")
        flops = 2.0 * np.prod(shape[:2]) * 9 * shape[2] * shape[3]
        splits = fwd_splits(shape, 1, torch.bfloat16)
        # context only, a different function: a dense 3x3 conv of the same
        # shape through cuDNN (bf16, channels_last); never used by the port
        xc = args[0].permute(0, 3, 1, 2)
        wc = args[3].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        conv = graph_ms(lambda: F.conv2d(xc, wc, args[4], padding=1), 20)
        conv_frame += n * conv
        times = mode_times(*fwd_fns(args), FWD_CLAMPS, 20, 5, eager=(3, 20))
        for mode, t in times.items():
            ms, eager, plain = t["ms"], t["eager_ms"], t["plain_ms"]
            per_frame[mode]["ms"] += n * ms
            per_frame[mode]["plain_ms"] += n * plain
            print(f"[time] {shape} x{n} {mode:7s} kernel {ms:.4f} ms "
                  f"(eager calls {eager:.4f})  plain {plain:.4f} ms  bound "
                  f"{bound:.4f} ms ({by}, {100 * bound / ms:.1f} % of it)  "
                  f"{flops / ms / 1e9:.1f} TFLOP/s  splits {splits}  [dense "
                  f"3x3 cuDNN conv, another function: {conv:.4f} ms]")
    for mode, v in per_frame.items():
        print(f"[time] {mode} per frame (16 nodes): kernel {v['ms']:.3f} ms  "
              f"plain {v['plain_ms']:.3f} ms  bound {bound_frame:.4f} ms "
              f"({100 * bound_frame / v['ms']:.1f} % of it)  [dense 3x3 "
              f"cuDNN convs of the same shapes: {conv_frame:.3f} ms]")

    for d, mode in ((det, "rowband:6"), (det_halo, f"halo:{HALO_R}")):
        e2e_times(d, mode, frames)
    by = "operations" if ops_share >= bound_frame / 2 else "bytes"
    return per_frame, bound_frame, by


def e2e_times(d, label, frames):
    """Host-clock times of a bf16 detector: `run` p50 over 10 frames
    (after 2), `run_batch` of the 4 frames (3 calls after 1), `run_stream`
    (depth 2) over 12 frames (after 2)."""
    import torch
    tots = []
    for i in range(12):
        ret = d.run(frames[i % len(frames)])
        if i >= 2:
            tots.append(ret["tot"])
    p50 = 1e3 * statistics.median(tots)
    print(f"[e2e] {label} run: p50 {p50:.2f} ms/frame, mean "
          f"{1e3 * statistics.mean(tots):.2f} ms, "
          f"{len(tots) / sum(tots):.2f} frames/s ({len(tots)} frames, bf16)")
    d.run_batch(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        d.run_batch(frames)
    dt = (time.perf_counter() - t0) / 3
    print(f"[e2e] {label} run_batch of {len(frames)}: "
          f"{1e3 * dt / len(frames):.2f} ms/frame, "
          f"{len(frames) / dt:.2f} frames/s")
    stream = [frames[i % len(frames)] for i in range(12)]
    for _ in d.run_stream(stream[:2]):
        pass
    t0 = time.perf_counter()
    n = sum(1 for _ in d.run_stream(iter(stream), depth=2))
    dt = time.perf_counter() - t0
    print(f"[e2e] {label} run_stream (depth 2): {1e3 * dt / n:.2f} "
          f"ms/frame, {n / dt:.2f} frames/s ({n} frames)")


def fwd_f32_bound_ms(shape, batch) -> tuple[float, str]:
    """Least time for one f32 forward of a node on the tensor cores:
    operations (each product counted once) over the TF32 peak against bytes
    (x, offsets, masks, W, b read once, the output written once) over
    HBM."""
    h, w, cin, cout = shape
    npix = batch * h * w
    flops = 2.0 * npix * 9 * cin * cout
    nbytes = 4.0 * (npix * cin + npix * 27 + 9 * cin * cout + cout
                    + npix * cout)
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_fwd_train_times():
    """The forward kernel as a train step runs it (f32, batch 4) per node
    and per step (16 nodes), in the three modes, against its bound and the
    plain version."""
    import torch
    per_step = {m: {"ms": 0.0, "plain_ms": 0.0} for m in FWD_CLAMPS}
    bound_step, ops_share = 0.0, 0.0
    for i, (shape, n) in enumerate(NODE_SHAPES.items()):
        args = node_inputs(shape, torch.float32, SEED + i, TRAIN_BATCH)
        bound, by = fwd_f32_bound_ms(shape, TRAIN_BATCH)
        bound_step += n * bound
        ops_share += n * bound * (by == "operations")
        flops = 2.0 * TRAIN_BATCH * np.prod(shape[:2]) * 9 * np.prod(shape[2:])
        splits = fwd_splits(shape, TRAIN_BATCH, torch.float32)
        times = mode_times(*fwd_fns(args), FWD_CLAMPS, 10, 3)
        for mode, t in times.items():
            ms, plain = t["ms"], t["plain_ms"]
            per_step[mode]["ms"] += n * ms
            per_step[mode]["plain_ms"] += n * plain
            print(f"[time-f32] {shape} x{n} b{TRAIN_BATCH} {mode:7s} kernel "
                  f"{ms:.4f} ms  plain {plain:.4f} ms  bound {bound:.4f} ms "
                  f"({by}, {100 * bound / ms:.1f} % of it)  "
                  f"{flops / ms / 1e9:.1f} TFLOP/s  splits {splits}")
        del args
    for mode, v in per_step.items():
        print(f"[time-f32] {mode} per step (16 nodes, batch {TRAIN_BATCH}, "
              f"f32): kernel {v['ms']:.3f} ms  plain {v['plain_ms']:.3f} ms  "
              f"bound {bound_step:.4f} ms "
              f"({100 * bound_step / v['ms']:.1f} % of it)")
    by = "operations" if ops_share >= bound_step / 2 else "bytes"
    return per_step, bound_step, by


def profile_device(fn):
    """Run `fn` under torch.profiler (one stream, so kernel times do not
    overlap): (wall ms, [(device ms, calls, name)] by self device time,
    largest first; empty when the trace holds no device time).  A
    `record_function` range (Adam's `Optimizer.step#...`) also appears on
    the device as a span over the kernels it launched, under its own name;
    device rows that share a name with a host event are such spans and are
    left out, or they would count those kernels twice."""
    wall_ms, events = profile_events(fn)
    return wall_ms, device_rows(events)


def profile_events(fn):
    """(wall ms, torch.profiler's key_averages) of one run of `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return wall_ms, prof.key_averages()


def device_rows(events):
    """profile_device's device rows of a profile's key_averages."""
    import torch
    host = {e.key for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0 and e.key not in host),
                  reverse=True)


def phase_profile(det, det_halo, frames):
    """Device time by kernel over 3 `run` calls (rowband:6), and the
    device's busy share of their wall time (one stream, so kernel times do
    not overlap); then the busy share of `run` and of `run_stream` (depth
    2) over the same 3 frames in halo:4."""
    paths = [("run", det, lambda d: [d.run(f) for f in frames[:3]]),
             ("halo:4 run", det_halo, lambda d: [d.run(f) for f in frames[:3]]),
             ("halo:4 run_stream", det_halo,
              lambda d: list(d.run_stream(iter(frames[:3]), depth=2)))]
    for label, d, fn in paths:
        wall_ms, rows = profile_device(lambda: fn(d))
        if not rows:
            print("[profile] no device time in the trace: busy share not "
                  "measured")
            return
        busy = sum(r[0] for r in rows)
        dcn_ms = sum(r[0] for r in rows if "dcn_fwd" in r[2])
        print(f"[profile] {label}, 3 frames: wall {wall_ms:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f} %), DCN kernel "
              f"{dcn_ms:.2f} ms ({100 * dcn_ms / busy:.1f} % of device time)")
        if label == "run":
            for ms, n, key in rows[:12]:
                print(f"[profile] {ms / 3:8.3f} ms/frame  {n // 3:4d} "
                      f"calls/frame  {key[:90]}")


def rel_max(got, ref) -> float:
    """max |got - ref| / max |ref| (0 where both are 0)."""
    d = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))


def bwd_inputs(shape, dtype, seed, batch, scale=4.0):
    """Node inputs and a seeded cotangent for the backward."""
    import torch
    args = node_inputs(shape, dtype, seed, batch, scale)
    g = torch.randn(batch, *shape[:2], shape[3],
                    generator=torch.Generator().manual_seed(seed + 1000))
    return args, g.to("cuda", dtype)


def check_bwd(label, args, g, kw, tol, tol_off):
    """The backward kernel (through its wrapper) against the plain
    backward on the same inputs, clamp keywords `kw`; returns the largest
    absolute error and the kernel's gradients."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    got = dcn.deform_conv2d_backward(*args, g, **kw)
    ref = dcn.deform_conv2d_backward_ref(*args, g, **kw)
    torch.cuda.synchronize()
    rel = {n: rel_max(a, b) for n, a, b in zip(BWD_NAMES, got, ref)}
    worst = max((a.double() - b.double()).abs().max().item()
                for a, b in zip(got, ref))
    print(f"[bwd] {label} rel_max " + " ".join(
        f"{n} {v:.2e}" for n, v in rel.items())
        + f" (tol {tol:g}, d offsets {tol_off:g})")
    check(all(np.isfinite(v) for v in rel.values())
          and rel["doffsets"] < tol_off
          and max(v for n, v in rel.items() if n != "doffsets") < tol,
          f"backward kernel disagrees: {label}")
    return worst, got


def phase_bwd_vs_plain():
    """dcn_bwd against the plain backward (autograd through
    deform_conv2d_ref, with the clamp's tie rule) at the 7 node shapes,
    batch 2.  Tolerances, relative max: f32 (TF32 off) 1e-4 for dx, dW,
    dmask, db (the same f32 sums in another order; dx by atomics) and 1e-3
    for the offsets (differences of neighbouring samples, so their error is
    that of the samples over the size of the difference); bf16 3e-2 (the
    plain version rounds the bilinear fractions and products to bf16 and
    scatters dx in bf16, the kernel keeps f32).  Then the card tests'
    tile shapes (`BWD_TILE_CASES`) in the three modes, and two calls at a
    split node in bf16 and f32 bit-equal but for dx.  The tie rules:
    rowband passes 0.5 of a y-offset gradient at exactly +-R; halo zeroes
    every offset gradient at |o| >= R on both axes, which must come out
    exactly 0."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    torch.backends.cuda.matmul.allow_tf32 = False
    tols = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (3e-2, 3e-2)}
    errs = dict.fromkeys(BWD_CLAMPS, 0.0)
    # the node shapes at batch 2; resdcn_101's first node at batch 1 and 4
    cases = [(shape, 2) for shape in NODE_SHAPES]
    cases += [(RESDCN101_NODE, b) for b in (1, TRAIN_BATCH)]
    for i, (shape, batch) in enumerate(cases):
        for dtype, (tol, tol_off) in tols.items():
            args, g = bwd_inputs(shape, dtype, SEED + i, batch)
            for mode, kw in BWD_CLAMPS.items():
                worst, _ = check_bwd(
                    f"b{batch} {shape} {mode:7s} {str(dtype)[6:]:8s}", args,
                    g, kw, tol, tol_off)
                if dtype == torch.float32:
                    errs[mode] = max(errs[mode], worst)
            del args, g
    for j, (case, dts) in enumerate(BWD_TILE_CASES.items()):
        batch, shape = case[0], case[1:]
        for dt in dts:
            dtype = getattr(torch, dt)
            args, g = bwd_inputs(shape, dtype, SEED + 100 + j, batch,
                                 scale=0.5 if shape[:2] == (1, 1) else 4.0)
            plan = dcn.bwd_plan(batch * shape[0] * shape[1], *shape[2:],
                                torch.cuda.get_device_properties(0)
                                .multi_processor_count)
            for mode, kw in BWD_CLAMPS.items():
                check_bwd(f"b{batch} {shape} {mode:7s} {dt:8s} splits "
                          f"{plan.splits}/{plan.data_splits}", args, g, kw,
                          *tols[dtype])
            del args, g
    # determinism: dW split over pixel ranges, d offsets and d masks over
    # tap ranges; all but dx (f32 atomics) bit-equal from call to call
    for shape in ((16, 32, 512, 256), (64, 128, 128, 64)):
        for dtype in tols:
            args, g = bwd_inputs(shape, dtype, SEED, TRAIN_BATCH)
            first = dcn.deform_conv2d_backward(*args, g, **BWD_CLAMPS["halo"])
            second = dcn.deform_conv2d_backward(*args, g, **BWD_CLAMPS["halo"])
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for n, a, b in
                      zip(BWD_NAMES, first, second) if n != "dx"),
                  f"two backward calls differ at {shape} {dtype}")
            print(f"[bwd] b{TRAIN_BATCH} {shape} {str(dtype)[6:]:8s}: two "
                  f"calls give bit-equal d offsets, d masks, dW, db")
            del args, g, first, second
    # the tie rules: offsets exactly at +-R (y, then x), beyond R, and all
    # offsets 0 (the offset convs' init: every sample on an integer
    # position, where the floor cell's derivative is taken)
    shape = (64, 128, 128, 64)
    (x, off, mask, wt, bias), g = bwd_inputs(shape, torch.float32, SEED, 2)
    cases = {"zero offsets": torch.zeros_like(off), "beyond R": off * 3}
    for axis, name in ((0, "y"), (1, "x")):
        o = off.clone()
        o[..., axis::2] = torch.where(off[..., axis::2] > 0, float(TRAIN_R),
                                      -float(TRAIN_R))
        cases[f"{name} at +-R"] = o
    for case, o in cases.items():
        for mode, kw in BWD_CLAMPS.items():
            _, got = check_bwd(f"{shape} {mode:7s} {case}",
                               (x, o, mask, wt, bias), g, kw, 1e-4, 1e-3)
            if mode == "halo":
                saturated = o.abs() >= HALO_R
                check(bool((got[1][saturated] == 0).all()),
                      f"halo offset gradient not 0 where saturated ({case})")
                print(f"[bwd] halo {case}: {int(saturated.sum())} saturated "
                      f"offset gradients, all exactly 0")
    return errs


def zero_counts():
    from centerpoly_tpu_torch.kernels import dcn
    for k in dcn.launches:
        dcn.launches[k] = 0


def exp_id(arch, kernel):
    return f"{arch}_{kernel.replace(':', '_')}"


def train_argv(root, kernel, arch="dla_34", val_intervals=1):
    """`main`'s arguments for one epoch at 512x1024, batch 4, f32."""
    return ["polydet", "--dataset", "cityscapes", "--arch", arch,
            "--data_dir", root, "--save_dir", os.path.join(root, "exp"),
            "--exp_id", exp_id(arch, kernel), "--input_h", "512",
            "--input_w", "1024", "--batch_size", str(TRAIN_BATCH),
            "--num_workers", "0", "--num_epochs", "1", "--val_intervals",
            str(val_intervals), "--dcn_kernel", kernel, *TRAIN_FLAGS]


def check_saved(root, arch, kernel, tags=("last", "best")):
    from centerpoly_tpu_torch.train import checkpoint
    save_dir = os.path.join(root, "exp", "cityscapes", "polydet",
                            exp_id(arch, kernel))
    for tag in tags:
        check(os.path.isfile(checkpoint.checkpoint_path(save_dir, tag)),
              f"no model_{tag}.pth after main ({arch}, {kernel})")


def loss_falls(tr, label):
    """5 updates on one fixed batch lower the loss."""
    batch = tr.put(next(iter(tr.train_loader)))
    losses = []
    for _ in range(6):
        tr.state, stats = tr.train_step(tr.state, batch)
        losses.append(float(stats["loss"]))
    print(f"[train] {label}: loss on one fixed batch over 5 updates: "
          + " ".join(f"{v:.4f}" for v in losses))
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"loss did not fall on a fixed batch ({label})")


def checkpoint_round_trip(tr, root):
    """Save the trainer's state and load it into a fresh model and Adam:
    every tensor, the Adam moments and the step come back exactly."""
    import torch
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.train import checkpoint, state as tstate
    ckdir = os.path.join(root, "ckpt")
    os.makedirs(ckdir, exist_ok=True)
    checkpoint.save_checkpoint(ckdir, "smoke", tr.state, 3)
    model = create_model(tr.cfg.arch, tr.cfg.heads, tr.cfg.head_conv,
                         dcn_kernel=tr.cfg.dcn_kernel)
    fresh = tstate.create_train_state(
        model.to("cuda", memory_format=torch.channels_last), tr.cfg.lr)
    fresh, epoch, report = checkpoint.load_checkpoint(ckdir, "smoke", fresh)
    a, b = tr.state.model.state_dict(), fresh.model.state_dict()
    oa, ob = tr.state.optimizer.state_dict(), fresh.optimizer.state_dict()
    check(epoch == 3 and fresh.step == tr.state.step
          and not report["skipped"] and not report["missing"]
          and all(torch.equal(a[k], b[k]) for k in a)
          and all(torch.equal(oa["state"][i][k], ob["state"][i][k])
                  for i in oa["state"] for k in ("exp_avg", "exp_avg_sq")),
          f"checkpoint round trip changed the state ({tr.cfg.arch})")
    print(f"[train] {tr.cfg.arch} checkpoint round trip: {len(a)} tensors, "
          f"Adam state and step {fresh.step} restored exactly")
    os.remove(checkpoint.checkpoint_path(ckdir, "smoke"))


def phase_train(root):
    """The training slice at full width through its entry point
    (`centerpoly_tpu_torch.main.main`: CityscapesMeta -> PolydetSampler ->
    Loader -> Trainer.fit) on the 2048x1024 fixture, in `off` (the
    training default, exact DCN) and rowband:4; then 5 steps on one fixed
    batch and a checkpoint round trip."""
    import torch
    from centerpoly_tpu_torch import main as tmain
    from centerpoly_tpu_torch.kernels import dcn

    trainers, launches = {}, {}
    for mode, kernel in TRAIN_MODES.items():
        zero_counts()
        t0 = time.perf_counter()
        tr = tmain.main(train_argv(root, kernel), device="cuda")
        torch.cuda.synchronize()
        counts = dict(dcn.launches)
        dt = time.perf_counter() - t0
        steps, n_val = tr.state.step, len(tr.val_loader)
        want = dict.fromkeys(counts, 0)
        want[mode] = 16 * (steps + n_val)
        want[f"bwd_{mode}"] = 16 * steps
        print(f"[train] main --dcn_kernel {kernel}: {steps} steps of batch "
              f"{TRAIN_BATCH} at {tr.cfg.input_h}x{tr.cfg.input_w} + {n_val} "
              f"val batches in {dt:.1f} s; launches {counts}")
        check(steps == 2 and counts == want,
              f"expected 16 forward + 16 backward launches a step, {want}")
        check_saved(root, "dla_34", kernel)
        launches[mode] = counts[f"bwd_{mode}"]
        trainers[mode] = tr
        loss_falls(tr, kernel)
    checkpoint_round_trip(trainers["exact"], root)
    return trainers, launches


def phase_train_vs_cpu(root):
    """`train_vs_cpu` for DLA-34 in each DCN mode."""
    for mode, kernel in TRAIN_MODES.items():
        train_vs_cpu(root, "dla_34", kernel, mode)


def train_vs_cpu(root, arch, kernel, mode, nodes=16, task="polydet"):
    """One f32 train step of `arch` on the card (TF32 off) against the
    port on the CPU at 128x256 (ctdet and exdet: 128x128, 80 classes, on
    the COCO box fixture under `root`; multi_pose: 128x128 on the COCO
    keypoints fixture under `root`), batch 2, from the trainer's seeded init;
    `mode` is the DCN mode whose backward kernel must run once a DCN node
    (`nodes`: DLA-34 16, resdcn 3) a step on the card, None for a net with
    no DCNv2 node (no launch at all).

    A random net in train mode is ill-conditioned (measured on DLA-34 and
    on tests/test_torch_hourglass.py's narrow 2-stack hourglass): train-mode
    BatchNorm removes each channel's mean from the gradient, so most
    gradients are small remainders of cancelling sums, and f32 on the CPU
    parts from f64 on the CPU by ~5 % (relative L2, median over tensors;
    up to ~25 % relative max).  So the check is three-fold:
      * the loss: relative 1e-4 (f32 against f64 on the CPU: ~2e-5);
      * the gradients with BatchNorm on its running statistics, which are
        well-conditioned (CPU f32 against f64: <5e-4): every gradient
        relative max 2e-3, card against CPU f32;
      * the train-mode step: each gradient's relative L2 distance to CPU
        f64 within 4x that of CPU f32 (+1e-3), tensors whose exact gradient
        is 0 (DCN biases before BatchNorm) left out; the parameters after
        Adam within 2 lr (Adam's first step moves a weight by ~lr sign(g));
        each BatchNorm statistic within relative max 1e-3 of the CPU's, or
        4x the CPU f32's own distance to f64 where that is larger: the
        deepest hourglass levels normalise over 4-16 values a channel at
        128x256, batch 2, where f32 on the CPU parts from f64 by more than
        1e-3 (DLA-34's floor is far below, so its bound stays 1e-3)."""
    import torch
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.data import (DATASETS, SAMPLERS,
                                           CocoPolyAnnotations, Loader)
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.train import state as tstate
    from centerpoly_tpu_torch.train.step import (loss_fn_for_task,
                                                 make_train_step, to_device)
    from centerpoly_tpu_torch.train.trainer import loss_config_for

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if task != "polydet":
        cfg = Config(task=task, dataset=TASK_DATASETS.get(task, "coco"),
                     arch=arch, input_h=128, input_w=128, lr=2e-4,
                     dcn_kernel=kernel)
    else:
        cfg = Config(arch=arch, input_h=128, input_w=256, rep="polar",
                     poly_loss="l1+iou", poly_order=True, lr=2e-4,
                     dcn_kernel=kernel)
    meta = DATASETS[cfg.dataset](root)
    sampler = SAMPLERS[task](cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    host = next(iter(Loader(sampler, len(sampler), 2, shuffle=False)))
    loss_cfg, task_loss = loss_config_for(cfg), loss_fn_for_task(task)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        sd = create_model(cfg.arch, cfg.heads, cfg.head_conv,
                          dcn_kernel=kernel).state_dict()

    def model_on(device, dtype=torch.float32):
        m = create_model(cfg.arch, cfg.heads, cfg.head_conv,
                         dcn_kernel=kernel)
        m.load_state_dict(sd)
        m.to(device, dtype)
        if device == "cuda":
            m.to(memory_format=torch.channels_last)
        return m

    def grads(model, dtype, train):
        dev = next(model.parameters()).device
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in to_device(host, dev).items()}
        model.train(train).zero_grad(set_to_none=True)
        outs = [{k: v.permute(0, 2, 3, 1) for k, v in o.items()}
                for o in model(batch["input"])]
        loss, _ = task_loss(outs, batch, loss_cfg)
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu().double()
                             for n, p in model.named_parameters()
                             if p.grad is not None}

    zero_counts()
    l_card, g_card = grads(model_on("cuda"), torch.float32, False)
    l_cpu, g_cpu = grads(model_on("cpu"), torch.float32, False)
    check(g_card.keys() == g_cpu.keys(), "gradients of other tensors")
    worst = max((rel_max(g_card[n], g_cpu[n]), n) for n in g_cpu)
    print(f"[train-vs-cpu] {task} {arch} {kernel} BatchNorm on running "
          f"statistics: "
          f"loss rel {abs(l_card - l_cpu) / abs(l_cpu):.2e}, worst "
          f"gradient rel_max {worst[0]:.2e} ({worst[1]})")
    check(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu) and worst[0] < 2e-3,
          f"eval-mode gradients on the card disagree ({kernel})")

    m64 = model_on("cpu", torch.float64)
    l64, g64 = grads(m64, torch.float64, True)
    b64 = {n: b.detach() for n, b in m64.named_buffers()
           if n.endswith(("running_mean", "running_var"))}
    steps = {}
    for dev in ("cuda", "cpu"):
        st = tstate.create_train_state(model_on(dev), base_lr=cfg.lr)
        st, stats = make_train_step(loss_cfg, task_loss)(
            st, to_device(host, dev))
        steps[dev] = (stats["loss"].item(),
                      {n: p.grad.detach().cpu().double()
                       for n, p in st.model.named_parameters()
                       if p.grad is not None},
                      {n: p.detach().cpu() for n, p in
                       st.model.named_parameters()},
                      {n: b.detach().cpu() for n, b in
                       st.model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))})
    counts = {k: v for k, v in dcn.launches.items() if v}
    (lc, gc, pc, bc), (lp, gp, pp, bp) = steps["cuda"], steps["cpu"]
    check(gc.keys() == gp.keys() == g64.keys(),
          "gradients of other tensors")
    norm = {n: g.norm().item() for n, g in g64.items()}
    top = max(norm.values())
    ratios, skipped = [], 0
    for n, ref in g64.items():
        if norm[n] < 1e-6 * top:
            skipped += 1
            continue
        e_card = (gc[n] - ref).norm().item() / norm[n]
        e_cpu = (gp[n] - ref).norm().item() / norm[n]
        ratios.append((e_card - 4 * e_cpu - 1e-3, e_card, e_cpu, n))
    bad = max(ratios)
    worst = max(ratios, key=lambda t: t[1])
    dp = max(((pc[n] - pp[n]).abs().max().item(), n) for n in pp)
    bn = []
    for n in bp:
        e_card, e_cpu = rel_max(bc[n], bp[n]), rel_max(bp[n], b64[n])
        bn.append((e_card - max(1e-3, 4 * e_cpu), e_card, e_cpu, n))
    db = max(bn)
    print(f"[train-vs-cpu] {task} {arch} {kernel} train step: loss card "
          f"{lc:.6f} cpu "
          f"{lp:.6f} f64 {l64:.6f} (rel {abs(lc - lp) / abs(lp):.2e}); "
          f"gradients rel L2 to f64: largest card {worst[1]:.2e} (cpu "
          f"f32 {worst[2]:.2e}, {worst[3]}), closest to its limit card "
          f"{bad[1]:.2e} against cpu f32 {bad[2]:.2e} ({bad[3]}), "
          f"{skipped} exact zeros left "
          f"out; params after Adam max |diff| {dp[0]:.2e} ({dp[1]}); "
          f"BatchNorm stats rel_max card vs cpu: largest "
          f"{max(b[1] for b in bn):.2e}, closest to its limit {db[1]:.2e} "
          f"(cpu f32 vs f64 {db[2]:.2e}, {db[3]}); cpu f32 vs f64 largest "
          f"{max(b[2] for b in bn):.2e}; launches {counts}")
    check(abs(lc - lp) <= 1e-4 * abs(lp) and bad[0] <= 0
          and dp[0] <= 2 * cfg.lr + 1e-6 and db[0] <= 0,
          f"train step on the card disagrees with the CPU ({kernel})")
    if mode is None:
        check(not counts, f"DCN launches on a net with no DCNv2 node: {counts}")
    else:
        check(counts.get(f"bwd_{mode}", 0) == 2 * nodes, f"card runs did "
              f"not launch the backward kernel {nodes} times each: {counts}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def bwd_bytes(shape, batch) -> float:
    """Bytes of one f32 backward of a node: x, offsets, masks, W, b and g
    read once; dx, d offsets, d masks, dW and db written once."""
    h, w, cin, cout = shape
    npix = batch * h * w
    return 4.0 * (2 * (npix * cin + npix * 27 + 9 * cin * cout + cout)
                  + npix * cout)


def bwd_bound_ms(shape, batch) -> tuple[float, str]:
    """Least time for one f32 backward of a node with every operation on
    the f32 CUDA cores (67 TFLOP/s; no tensor core, as v1's cuBLAS f32
    GEMMs ran): gk = g W_k^T and dW, 2 N 9 Cin Cout each, plus ~32 per
    (pixel, tap, channel) for the four corners, the three sums and the four
    scatter products, against `bwd_bytes` over HBM."""
    h, w, cin, cout = shape
    npix = batch * h * w
    flops = 4.0 * npix * 9 * cin * cout + 32.0 * npix * 9 * cin
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = bwd_bytes(shape, batch) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_bound_tf32_ms(shape, batch) -> tuple[float, str, float]:
    """Least time for one f32 backward of a node as v2 runs it: the largest
    of the two products (4 N 9 Cin Cout operations, each counted once) at
    the TF32 tensor-core peak, the ~32 elementwise operations per (pixel,
    tap, channel) at the f32 peak (the tensor cores and the f32 units run
    at the same time, so the two do not add), and `bwd_bytes` over HBM.
    The third value is the looser bound with the two operation times
    added."""
    h, w, cin, cout = shape
    npix = batch * h * w
    t_mma = 4.0 * npix * 9 * cin * cout / PEAK_TF32_FLOPS
    t_elt = 32.0 * npix * 9 * cin / PEAK_F32_FLOPS
    t_bytes = bwd_bytes(shape, batch) / PEAK_BYTES
    t_ops = max(t_mma, t_elt)
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * max(t_mma + t_elt, t_bytes))


def phase_loader_workers(root, n_batches=8, workers=4):
    """The loader as `main` runs it by default: `workers` spawned
    processes encoding a shuffled epoch of `n_batches` batches of 2048x1024
    `.npy` frames.  Host time to the first batch (the pool's start) and
    per batch after it."""
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.data import (CityscapesMeta,
                                           CocoPolyAnnotations, Loader,
                                           PolydetSampler)
    from centerpoly_tpu_torch.data.fixture import write_rect_fixture
    root = write_rect_fixture(os.path.join(root, "loader"),
                              n_batches * TRAIN_BATCH, SEED + 1, *FRAME_HW)
    cfg = Config.from_args(["polydet", *TRAIN_FLAGS])
    meta = CityscapesMeta(root)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    loader = Loader(sampler, len(sampler), TRAIN_BATCH, seed=cfg.seed,
                    num_workers=workers)
    t0 = time.perf_counter()
    stamps = [time.perf_counter() for _ in loader]
    check(len(stamps) == n_batches, f"loader gave {len(stamps)} batches")
    per = (stamps[-1] - stamps[0]) / (n_batches - 1)
    print(f"[train-time] loader with {workers} worker processes: first batch "
          f"after {1e3 * (stamps[0] - t0):.1f} ms, then {1e3 * per:.1f} ms per "
          f"batch of {TRAIN_BATCH} ({n_batches} batches, 2048x1024 .npy, "
          f"{os.cpu_count()} host cores)")


def bwd_kernel_ms(args, g, parts, calls=3, tries=3):
    """Device ms of each kernel of one backward call (exact mode), from
    the profiler over `calls` calls; returns them by name in `parts` (the
    rest under "other") and how many calls the trace held.  A trace can
    come back without some calls' events (seen after earlier profiler
    sessions in the process), so the sums are divided by the calls traced
    (each launches dcn_bwd_data once) and an empty trace is taken again."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    from torch.profiler import ProfilerActivity, profile
    dcn.deform_conv2d_backward(*args, g)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                dcn.deform_conv2d_backward(*args, g)
            torch.cuda.synchronize()
        node, traced = dict.fromkeys((*parts, "other"), 0.0), 0
        for e in prof.key_averages():
            part = next((k for k in parts if k in e.key), "other")
            node[part] += e.self_device_time_total / 1e3
            traced += e.count if part == "dcn_bwd_data" else 0
        if traced:
            break
    return {k: v / max(traced, 1) for k, v in node.items()}, traced


def phase_bwd_times(check_plain: bool = True):
    """dcn_bwd per node and per step as a train step runs it (f32, batch 4,
    TF32 off): each node's kernel gradients first held against the plain
    backward on the same inputs (`check_bwd`, phase 8's f32 tolerances;
    skipped by `--bwd-times`), then device time by CUDA graph replay with
    the eager wrapper's time beside it, against its TF32-basis bound (and
    the f32-CUDA-core one), the plain backward, for context v1's two f32
    cuBLAS GEMMs at each node's shape, and the device time of each kernel
    of one call (torch.profiler, exact mode).  Returns the times per step,
    the bound, its kind, the f32-core bound and the largest absolute error
    by mode."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn

    torch.backends.cuda.matmul.allow_tf32 = False
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_step = {m: {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0}
                for m in BWD_CLAMPS}
    errs = dict.fromkeys(BWD_CLAMPS, 0.0)
    parts = ("dcn_bwd_data", "dcn_bwd_weight", "dcn_bwd_reduce")
    by_kernel = dict.fromkeys((*parts, "other"), 0.0)
    bound_step, sum_bound_step, f32_bound_step = 0.0, 0.0, 0.0
    gemm_step, ops_share = 0.0, 0.0
    for i, (shape, n) in enumerate(NODE_SHAPES.items()):
        args, g = bwd_inputs(shape, torch.float32, SEED + i, TRAIN_BATCH)
        bound, by, sum_bound = bwd_bound_tf32_ms(shape, TRAIN_BATCH)
        f32_bound, _ = bwd_bound_ms(shape, TRAIN_BATCH)
        bound_step += n * bound
        sum_bound_step += n * sum_bound
        f32_bound_step += n * f32_bound
        ops_share += n * bound * (by == "operations")
        h, w, cin, cout = shape
        npix = TRAIN_BATCH * h * w
        plan = dcn.bwd_plan(npix, cin, cout, n_sm)
        # context only, not a library time of this function: v1's two f32
        # cuBLAS GEMMs (gk = g W^T into an (npix, 9 Cin) buffer, then
        # dW = buffer^T g) at this node's shape; the port no longer calls
        # them
        g2, w2 = g.reshape(npix, cout), args[3].reshape(9 * cin, cout)
        buf = torch.empty(npix, 9 * cin, device="cuda")
        dw = torch.empty(9 * cin, cout, device="cuda")
        gemm = graph_ms(lambda: (torch.mm(g2, w2.t(), out=buf),
                                 torch.mm(buf.t(), g2, out=dw)), 5)
        gemm_step += n * gemm
        del buf, dw
        for mode, kw in BWD_CLAMPS.items():
            if check_plain:
                worst, _ = check_bwd(f"b{TRAIN_BATCH} {shape} {mode:7s} "
                                     f"float32", args, g, kw, 1e-4, 1e-3)
                errs[mode] = max(errs[mode], worst)
        times = mode_times(*bwd_fns(args, g), BWD_CLAMPS, 5, 3, eager=(2, 10))
        for mode, t in times.items():
            ms, eager, plain = t["ms"], t["eager_ms"], t["plain_ms"]
            per_step[mode]["ms"] += n * ms
            per_step[mode]["eager_ms"] += n * eager
            per_step[mode]["plain_ms"] += n * plain
            print(f"[time-bwd] {shape} x{n} b{TRAIN_BATCH} {mode:7s} kernels "
                  f"{ms:.4f} ms (eager wrapper {eager:.4f})  plain "
                  f"{plain:.4f} ms  bound {bound:.4f} ms ({by}, TF32; "
                  f"{100 * bound / ms:.1f} % of it; f32 CUDA cores "
                  f"{f32_bound:.4f})  dW splits {plan.splits}, tap ranges "
                  f"{plan.data_splits}  [v1's two f32 cuBLAS GEMMs at this "
                  f"shape, context: {gemm:.4f} ms]")
        node, traced = bwd_kernel_ms(args, g, parts)
        for k, v in node.items():
            by_kernel[k] += n * v
        print(f"[time-bwd] {shape} exact by kernel (profiler, {traced} of 3 "
              f"calls traced): "
              + "  ".join(f"{k} {v:.4f}" for k, v in node.items()) + " ms")
        del args, g
    for mode, v in per_step.items():
        print(f"[time-bwd] {mode} per step (16 nodes, batch {TRAIN_BATCH}, "
              f"f32): kernels {v['ms']:.3f} ms (eager wrapper "
              f"{v['eager_ms']:.3f})  plain {v['plain_ms']:.3f} ms  bound "
              f"{bound_step:.4f} ms (TF32; {100 * bound_step / v['ms']:.1f} "
              f"% of it; {sum_bound_step:.4f} with the tensor-core and "
              f"elementwise times added; f32 CUDA cores "
              f"{f32_bound_step:.4f})  [v1's f32 cuBLAS GEMMs: "
              f"{gemm_step:.3f} ms]")
    print("[time-bwd] exact per step by kernel (profiler): " + "  ".join(
        f"{k} {v:.3f}" for k, v in by_kernel.items()) + " ms")
    by = "operations" if ops_share >= bound_step / 2 else "bytes"
    return per_step, bound_step, by, f32_bound_step, errs


def step_times(tr, label):
    """Train step p50 and images/s over 8 steps on one device-resident
    batch (after 2), and the peak device memory of those steps."""
    import torch
    batch = tr.put(next(iter(tr.train_loader)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        tr.state, _ = tr.train_step(tr.state, batch)
    times = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, _ = tr.train_step(tr.state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    print(f"[train-time] {label}: step p50 {1e3 * p50:.2f} ms, "
          f"min {1e3 * min(times):.2f} ms, {TRAIN_BATCH / p50:.2f} images/s "
          f"(batch {TRAIN_BATCH}, {tr.cfg.input_h}x{tr.cfg.input_w}, f32, "
          f"8 steps); peak memory of its steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_train_times(trainers):
    """Train step p50, images/s and peak memory per mode (f32, batch 4: the
    training default); the loader's host time per batch; one profiled step
    in `off` and in halo:4."""
    import torch
    from centerpoly_tpu_torch.data import stack_batch

    # the library defaults a training run gets: f32 matmuls in full f32,
    # cuDNN convolutions in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    for mode, tr in trainers.items():
        step_times(tr, tr.cfg.dcn_kernel)
    sampler = trainers["exact"].train_loader.sampler
    host = []
    for k in range(3):
        t0 = time.perf_counter()
        stack_batch([sampler(i % len(sampler))
                     for i in range(k * TRAIN_BATCH, (k + 1) * TRAIN_BATCH)])
        host.append(time.perf_counter() - t0)
    print(f"[train-time] loader host time per batch of {TRAIN_BATCH} "
          f"(2048x1024 .npy frames, one process): mean "
          f"{1e3 * statistics.mean(host):.1f} ms over 3 batches")

    for mode in ("exact", "halo"):
        tr = trainers[mode]
        batch = tr.put(next(iter(tr.train_loader)))

        def step():
            tr.state, _ = tr.train_step(tr.state, batch)
        wall_ms, rows = profile_device(step)
        if not rows:
            print("[train-profile] no device time in the trace: busy share "
                  "not measured")
            continue
        busy = sum(r[0] for r in rows)
        fwd = sum(r[0] for r in rows if "dcn_fwd" in r[2])
        bwd = sum(r[0] for r in rows if "dcn_bwd" in r[2])
        print(f"[train-profile] one {tr.cfg.dcn_kernel} step: wall "
              f"{wall_ms:.2f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / wall_ms:.1f} %), dcn_fwd {fwd:.2f} ms, "
              f"dcn_bwd kernels {bwd:.2f} ms "
              f"({100 * (fwd + bwd) / busy:.1f} % of device time)")
        for ms, n, key in rows[:15 if mode == "exact" else 6]:
            print(f"[train-profile] {ms:8.3f} ms {n:4d} calls  {key[:90]}")


def count_free(fn, label):
    """Run one path of a net with no DCNv2 node with the launch counts
    zeroed just before and read just after: every count must read 0."""
    from centerpoly_tpu_torch.kernels import dcn
    zero_counts()
    out = fn()
    counts = {k: v for k, v in dcn.launches.items() if v}
    check(not counts, f"{label}: DCN launches {counts} on a net with no "
          f"DCNv2 node")
    return out


def conv_tflop(arch, heads, hw) -> float:
    """TFLOP of convolution in one forward of `arch` on one (h, w) image,
    counted from the shapes (2 x output elements x Cin / groups x kh x
    kw, each conv), on the meta device."""
    import torch
    from centerpoly_tpu_torch.models import create_model
    total = []

    def count(mod, inp, out):
        total.append(2 * out.numel() * mod.in_channels // mod.groups
                     * mod.kernel_size[0] * mod.kernel_size[1])
    with torch.device("meta"):
        model = create_model(arch, heads, 256)
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.register_forward_hook(count)
        model(torch.empty(1, 3, *hw))
    return sum(total) / 1e12


def print_profile(label, wall_ms, rows, per=1):
    """Print the device's busy share of a profiled window, its device
    time by kind and its 10 largest device operations (per call of the
    window's `per` repeats); return {kind: device ms a call}."""
    if not rows:
        print(f"[{label}] no device time in the trace: busy share not "
              f"measured")
        return {}
    busy = sum(r[0] for r in rows)
    kinds = collections.Counter()
    for ms, _, key in rows:
        kinds[next((kind for kind, words in PROFILE_KINDS.items()
                    if any(w in key for w in words)), "other")] += ms
    print(f"[{label}] wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f} %): " + ", ".join(
              f"{kind} {ms / per:.3f} ms" for kind, ms in kinds.most_common())
          + (" a call" if per > 1 else ""))
    for ms, n, key in rows[:10]:
        print(f"[{label}] {ms / per:8.3f} ms  {n // per:4d} calls  "
              f"{key[:90]}")
    return {kind: ms / per for kind, ms in kinds.items()}


def profile_step(tr, label):
    """One profiled train step of `tr` on a device-resident batch:
    `print_profile`'s device time by kind."""
    batch = tr.put(next(iter(tr.train_loader)))

    def step():
        tr.state, _ = tr.train_step(tr.state, batch)
    wall_ms, rows = profile_device(step)
    return print_profile(label, wall_ms, rows)


def phase_hourglass_infer(frames):
    """Phase 11: smallhourglass polydet inference at full width (8
    classes, 16 vertices, heads 256 wide, 512x1024 input for 2048x1024
    frames), bf16, seeded random weights at conv gain `HG_GAIN`: `run` on
    each seeded frame of phase 4, `run_batch` of 4 and `run_stream` (depth
    2), each with the DCN launch counts zeroed just before and read just
    after (0: the net has no DCNv2 node); `run_stream` equal to `run` frame
    by frame (cuDNN on its deterministic algorithms for both); the f32
    heads on the card (TF32 off) against the port on the CPU; times; the
    device's busy share of `run` and its top device operations."""
    import torch
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.models import create_model

    cfg = Config(arch="smallhourglass")
    check(not cfg.prefer_fast_inference_dcn() and cfg.num_stacks == 1
          and (cfg.input_h, cfg.input_w, cfg.head_conv) == (512, 1024, 256),
          f"smallhourglass config {cfg.input_h}x{cfg.input_w} "
          f"head_conv {cfg.head_conv}")
    sd = random_state_dict(create_model(cfg.arch, cfg.heads, cfg.head_conv),
                           SEED, gain=HG_GAIN)
    det = create_detector(cfg, sd)
    check(det.device.type == "cuda" and det.dtype == torch.bfloat16,
          f"detector on {det.device} in {det.dtype}")
    n_params = sum(p.numel() for p in det.model.parameters())
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    for i, frame in enumerate(frames):
        ret = count_free(lambda: det.run(frame), "smallhourglass run")
        runs.append(ret["results"])
        rows = np.concatenate([np.asarray(v) for v in ret["results"].values()])
        check(rows.shape == (cfg.K, 4 + 1 + 2 * cfg.nbr_points + 1)
              and np.isfinite(rows).all(), f"hourglass frame {i} results")
    batch = count_free(lambda: det.run_batch(frames), "run_batch")
    check(len(batch) == len(frames) and all(
        sum(len(v) for v in b["results"].values()) == cfg.K for b in batch),
        "run_batch results")
    streamed = count_free(lambda: list(det.run_stream(iter(frames), depth=2)),
                          "run_stream")
    torch.backends.cudnn.deterministic = flags
    check(len(streamed) == len(frames) and all(
        np.array_equal(np.asarray(got[j]), np.asarray(ref[j]))
        for got, ref in zip(streamed, runs) for j in ref),
        "run_stream differs from run()")
    print(f"[hourglass] smallhourglass ({n_params} parameters, bf16): run "
          f"on {len(frames)} frames, run_batch of {len(frames)}, run_stream "
          f"(depth 2) equal to run(); 0 DCN launches in each; results "
          f"finite, {cfg.K} rows")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = Config(arch="smallhourglass", mixed_precision=False)
    det32 = create_detector(cfg32, sd)
    det_cpu = create_detector(cfg32, sd, device="cpu")
    trans, meta = det._scaled_trans(*FRAME_HW, 1.0)
    with torch.no_grad():
        x_cpu = det_cpu._pre_device(torch.from_numpy(frames[0])[None], trans,
                                    (meta["inp_h"], meta["inp_w"]))
        ref = det_cpu._heads(x_cpu)
        got32 = det32._heads(x_cpu.to("cuda",
                                      memory_format=torch.channels_last))
        got16 = det._heads(x_cpu.to("cuda", torch.bfloat16,
                                    memory_format=torch.channels_last))
    print("[hourglass] max |head| (CPU f32): " + " ".join(
        f"{k} {v.abs().max().item():.2f}" for k, v in ref.items()))
    check_heads("hourglass", ref, got32, got16)
    del det32, det_cpu, got32

    e2e_times(det, "smallhourglass", frames)
    wall_ms, rows = profile_device(lambda: [det.run(f) for f in frames[:3]])
    kinds = print_profile("hourglass-profile run, 3 frames", wall_ms, rows, 3)
    tflop = conv_tflop(cfg.arch, cfg.heads, (cfg.input_h, cfg.input_w))
    if kinds.get("convolution"):
        rate = tflop / kinds["convolution"] * 1e15    # FLOP/s
        print(f"[hourglass] {tflop:.4f} TFLOP of convolution a frame "
              f"(counted from shapes) in {kinds['convolution']:.3f} ms: "
              f"{rate / 1e12:.1f} TFLOP/s ({100 * rate / PEAK_BF16_FLOPS:.1f}"
              f" % of the bf16 peak)")
    return det


def phase_hourglass_train(root):
    """Phase 12: smallhourglass then Hourglass-104 (2 stacks) training
    through `main` at 512x1024, batch 4, f32, the paper's v2 loss, on the
    phase 9 fixture, each with the DCN launch counts zeroed just before and
    read just after (0); smallhourglass: one epoch of 2 steps and a val
    pass, the loss falling on one fixed batch, a checkpoint round trip and
    `train_vs_cpu`; Hourglass-104: one epoch of 2 steps (no val: its
    checkpoint with Adam's moments is 2.3 GB); then for both the step p50,
    images/s, peak device memory and one profiled step."""
    import torch
    from centerpoly_tpu_torch import main as tmain

    for arch, stacks, val in (("smallhourglass", 1, 1), ("hourglass", 2, 0)):
        t0 = time.perf_counter()
        tr = count_free(lambda: tmain.main(train_argv(root, "off", arch, val),
                                           device="cuda"),
                        f"main --arch {arch}")
        dt = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tr.state.model.parameters())
        print(f"[hourglass-train] main --arch {arch}: {tr.state.step} steps "
              f"of batch {TRAIN_BATCH} at {tr.cfg.input_h}x{tr.cfg.input_w} "
              f"in {dt:.1f} s (val every {val} epoch); {n_params} parameters, "
              f"{tr.cfg.num_stacks} stack(s); 0 DCN launches")
        check(tr.state.step == 2 and tr.cfg.num_stacks == stacks
              and tr.state.model.num_stacks == stacks,
              f"main --arch {arch}: {tr.state.step} steps")
        check_saved(root, arch, "off", ("last", "best") if val else ("last",))
        if arch == "smallhourglass":
            count_free(lambda: loss_falls(tr, arch), "fixed-batch steps")
            checkpoint_round_trip(tr, root)
        # the library defaults a training run gets (as phase 10)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        step_times(tr, arch)
        kinds = profile_step(tr, f"hourglass-profile {arch} step")
        # a step's convolutions: the forward, its data gradient and its
        # weight gradient, each about the forward's operations
        tflop = 3 * TRAIN_BATCH * conv_tflop(arch, tr.cfg.heads, (512, 1024))
        if kinds.get("convolution"):
            rate = tflop / kinds["convolution"] * 1e15    # FLOP/s
            print(f"[hourglass-train] {arch}: ~{tflop:.3f} TFLOP of "
                  f"convolution a step (3 x forward x batch, counted from "
                  f"shapes) in {kinds['convolution']:.3f} ms: "
                  f"{rate / 1e12:.1f} TFLOP/s "
                  f"({100 * rate / PEAK_TF32_FLOPS:.1f} % of the TF32 peak)")
        del tr
        torch.cuda.empty_cache()
        if arch == "smallhourglass":
            train_vs_cpu(root, arch, "off", None)


def phase_resdcn_node_times():
    """resdcn_101's first node, (16, 32, 2048, 256), timed as the other
    nodes of phases 6 and 10 (`mode_times`): the bf16 forward at batch 1
    (inference) and the f32 forward and backward at batch 4 (a train
    step) in the three modes, beside the plain version and the bound; the
    forward and backward plans (K chunks and splits, dW splits and tap
    ranges) at this Cin.  Returns {"fwd" | "fwd_f32" | "bwd": {mode:
    {"ms", "plain_ms", "bound_ms", "bound_by"}}}."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = RESDCN101_NODE
    h, w, cin, cout = shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for key, b, dtype, iters, plain_iters in (
            ("fwd", 1, torch.bfloat16, 20, 5),
            ("fwd_f32", TRAIN_BATCH, torch.float32, 10, 3),
            ("bwd", TRAIN_BATCH, torch.float32, 5, 3)):
        if key == "bwd":
            args, g = bwd_inputs(shape, dtype, SEED, b)
            fns, clamps = bwd_fns(args, g), BWD_CLAMPS
            bound, by, _ = bwd_bound_tf32_ms(shape, b)
            plan = dcn.bwd_plan(b * h * w, cin, cout, n_sm)
        else:
            args = node_inputs(shape, dtype, SEED, b)
            fns, clamps = fwd_fns(args), FWD_CLAMPS
            bound, by = (node_bound_ms(shape) if dtype == torch.bfloat16
                         else fwd_f32_bound_ms(shape, b))
            plan = dcn.fwd_plan(b * h * w, cin, cout, n_sm, dtype)
        out[key] = mode_times(*fns, clamps, iters, plain_iters)
        for mode, t in out[key].items():
            t.update(bound_ms=bound, bound_by=by)
            print(f"[resdcn-node] {shape} b{b} {str(dtype)[6:]} {mode:7s} "
                  f"dcn_{key[:3]} {t['ms']:.4f} ms plain {t['plain_ms']:.4f} "
                  f"ms bound {bound:.4f} ms ({by}"
                  f"{'' if dtype == torch.bfloat16 else ', TF32'}; "
                  f"{100 * bound / t['ms']:.1f} % of it) plan {plan}")
        del args, fns
    return out


def heads_vs_cpu(arch, sd, frame, nodes):
    """One f32 forward of `arch` on the card (TF32 off) against the port
    on the CPU, on a 2048x1024 frame warped to the 512x1024 input: every
    head within 2e-3 relative max; `nodes` exact-mode DCN launches on the
    card (0 for a net without DCNv2)."""
    import torch
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.infer.detector import create_detector
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(arch=arch, mixed_precision=False, dcn_kernel="off")
    det = create_detector(cfg, sd)
    det_cpu = create_detector(cfg, sd, device="cpu")
    trans, meta = det._scaled_trans(*FRAME_HW, 1.0)
    with torch.no_grad():
        x = det_cpu._pre_device(torch.from_numpy(frame)[None], trans,
                                (meta["inp_h"], meta["inp_w"]))
        ref = det_cpu._heads(x)
        if nodes:
            got, _ = run_counted(lambda: det._heads(
                x.to("cuda", memory_format=torch.channels_last)), "exact",
                nodes)
        else:
            got = count_free(lambda: det._heads(
                x.to("cuda", memory_format=torch.channels_last)), arch)
    check_heads(f"{arch} {x.shape[2]}x{x.shape[3]}", ref, got)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def random_weights(arch):
    """Seeded random weights of `arch` at its default heads and head_conv
    (`random_state_dict`; ResNet-101 at RES101_GAIN)."""
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.models import create_model
    cfg = Config(arch=arch)
    gain = RES101_GAIN if arch.endswith("_101") else 1.2
    return random_state_dict(create_model(arch, cfg.heads, cfg.head_conv),
                             SEED, gain)


def step_launches(tr, nodes):
    """One train step of `tr` on a batch of its loader, with the launch
    counts zeroed just before and read just after: `nodes` exact forward
    and `nodes` exact backward launches, none of another kind.  Returns
    the counts."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    batch = tr.put(next(iter(tr.train_loader)))
    torch.cuda.synchronize()
    zero_counts()
    tr.state, _ = tr.train_step(tr.state, batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in dcn.launches.items() if v}
    check(counts == {"exact": nodes, "bwd_exact": nodes}, f"one train "
          f"step: expected {nodes} forward + {nodes} backward launches, got "
          f"{counts}")
    return counts


def phase_resdcn18(frames, root):
    """Phase 15: resdcn_18 at full width (8 classes, 16 vertices, head_conv
    64, 512x1024 input for 2048x1024 uint8 frames, K=128), seeded random
    weights: the bf16 detector in the inference default rowband:6 runs
    `run` on each frame and `run_batch` of 4, each with the launch counts
    zeroed just before and read just after (3 `dcn_fwd` launches a
    forward, at the 3 node shapes), its times; f32 heads on the card
    against the port on the CPU (< 2e-3); `main --arch resdcn_18` for one
    epoch on the phase 9 fixture (batch 4, f32, `off`: 3 forward + 3
    backward launches a step), its step p50, images/s and peak memory;
    `train_vs_cpu` in `off`.  Returns the launch counts: "run" (a frame)
    and "step" (`step_launches`: one train step, by kernel)."""
    import torch
    from centerpoly_tpu_torch import main as tmain
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.models.deform_conv import DCNv2

    arch, nodes = "resdcn_18", len(RESDCN_NODES["resdcn_18"])
    cfg = Config(arch=arch)
    check(cfg.prefer_fast_inference_dcn() and cfg.dcn_kernel == "rowband:6"
          and (cfg.input_h, cfg.input_w, cfg.head_conv, cfg.K)
          == (512, 1024, 64, 128), f"{arch} config")
    sd = random_weights(arch)
    det = create_detector(cfg, sd)
    check(det.device.type == "cuda" and det.dtype == torch.bfloat16,
          f"detector on {det.device} in {det.dtype}")
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(
            (*inp[0].shape[2:], inp[0].shape[1], out.shape[1])))
        for m in det.model.modules() if isinstance(m, DCNv2)]
    launches = {}
    for i, frame in enumerate(frames):
        ret, launches["run"] = run_counted(lambda: det.run(frame), "rowband",
                                           nodes)
        rows = np.concatenate([np.asarray(v) for v in ret["results"].values()])
        check(rows.shape == (cfg.K, 4 + 1 + 2 * cfg.nbr_points + 1)
              and np.isfinite(rows).all(), f"{arch} frame {i} results")
    for h in hooks:
        h.remove()
    check(shapes[:nodes] == RESDCN_NODES[arch], f"DCN node shapes {shapes}")
    batch, n = run_counted(lambda: det.run_batch(frames), "rowband", nodes)
    check(len(batch) == len(frames), "run_batch returned the wrong count")
    print(f"[resdcn18] bf16 rowband:6: run {launches['run']} dcn_fwd "
          f"launches a frame at {shapes[:nodes]}, run_batch of "
          f"{len(frames)} {n}; results finite, {cfg.K} rows")
    e2e_times(det, f"{arch} rowband:6", frames)
    wall_ms, rows = profile_device(lambda: [det.run(f) for f in frames[:3]])
    print_profile("resdcn18-profile run, 3 frames", wall_ms, rows, 3)
    del det
    heads_vs_cpu(arch, sd, frames[0], nodes)

    zero_counts()
    tr = tmain.main(train_argv(root, "off", arch), device="cuda")
    torch.cuda.synchronize()
    counts = dict(dcn.launches)
    steps, n_val = tr.state.step, len(tr.val_loader)
    want = dict.fromkeys(counts, 0)
    want["exact"], want["bwd_exact"] = nodes * (steps + n_val), nodes * steps
    print(f"[resdcn18] main --arch {arch} --dcn_kernel off: {steps} steps of "
          f"batch {TRAIN_BATCH} at {tr.cfg.input_h}x{tr.cfg.input_w} + "
          f"{n_val} val batches; launches {counts}")
    check(steps == 2 and counts == want, f"expected {nodes} forward + "
          f"{nodes} backward launches a step, {want}")
    check_saved(root, arch, "off")
    loss_falls(tr, arch)
    launches["step"] = step_launches(tr, nodes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    step_times(tr, f"{arch} off")
    profile_step(tr, f"resdcn18-profile {arch} step")
    del tr
    torch.cuda.empty_cache()
    train_vs_cpu(root, arch, "off", "exact", nodes)
    return launches


def phase_resdcn101(frames, root):
    """Phase 16: resdcn_101 (its first DCN node reads 2048 channels; its
    kernels against the plain versions at that node are in phases 3 and
    8, its times in `phase_resdcn_node_times`): one f32 forward at full
    width on the card against the port on the CPU (3 `dcn_fwd` launches);
    `main --arch resdcn_101` for one epoch of 2 steps (batch 4, 512x1024,
    f32, `off`, no val: 3 forward + 3 backward launches a step) and its
    step p50, images/s and peak memory.  Then res_18, res_101 and dlav0_34:
    one f32 forward each on the card against the CPU, no DCN launch.  The
    ResNet-101 weights are at RES101_GAIN.  Returns the launch counts of
    one resdcn_101 train step by kernel (`step_launches`)."""
    import torch
    from centerpoly_tpu_torch import main as tmain
    from centerpoly_tpu_torch.kernels import dcn

    arch, nodes = "resdcn_101", len(RESDCN_NODES["resdcn_101"])
    heads_vs_cpu(arch, random_weights(arch), frames[1], nodes)
    zero_counts()
    tr = tmain.main(train_argv(root, "off", arch, val_intervals=0),
                    device="cuda")
    torch.cuda.synchronize()
    counts = {k: v for k, v in dcn.launches.items() if v}
    steps = tr.state.step
    print(f"[resdcn101] main --arch {arch} --dcn_kernel off: {steps} steps "
          f"of batch {TRAIN_BATCH} at {tr.cfg.input_h}x{tr.cfg.input_w}; "
          f"launches {counts}")
    check(steps == 2 and counts == {"exact": nodes * steps,
                                    "bwd_exact": nodes * steps},
          f"expected {nodes} forward + {nodes} backward launches a step")
    check_saved(root, arch, "off", ("last",))
    step = step_launches(tr, nodes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    step_times(tr, f"{arch} off")
    profile_step(tr, f"resdcn101-profile {arch} step")
    del tr
    torch.cuda.empty_cache()
    for arch in ("res_18", "res_101", "dlav0_34"):
        heads_vs_cpu(arch, random_weights(arch), frames[2], 0)
    return step


EVAL_FRAMES = 4
EVAL_PASSES = 8     # timed passes over the split per test.py loop
EVAL_TOP = 32       # rows a frame compared between eval_batch 1 and 4
EVAL_CELL_PX = 8.0  # one output cell in 2048x1024 frame pixels (stride 4, 1/2)
ORACLE_ARGS = ["--eval_oracle_hm", "--eval_oracle_poly", "--eval_oracle_offset",
               "--eval_oracle_pseudo_depth"]


def eval_host_times(meta, results, ann, out_dir, card):
    """Host ms of the eval path's parts on `results`: the rasterizer per
    frame, the PNG codec per mask (encode, decode) and per frame (decode
    of the fixture's frame and of the same pixels Paeth-filtered, as real
    Cityscapes PNGs are), the GT decode and the matcher per frame."""
    from centerpoly_tpu_torch.eval.harness import run_instance_eval
    from centerpoly_tpu_torch.eval.instance_eval import (
        InstanceEvalConfig, load_prediction_dir, match_image)
    from centerpoly_tpu_torch.eval.rasterize import rasterize_results
    from centerpoly_tpu_torch.utils import png

    id_to_file = {int(i): im["file_name"] for i, im in ann.imgs.items()}
    n = len(results)
    t0 = time.perf_counter()
    rasterize_results(results, meta, out_dir, id_to_file)
    rast = 1e3 * (time.perf_counter() - t0) / n
    masks = [os.path.join(out_dir, "masks", f)
             for f in sorted(os.listdir(os.path.join(out_dir, "masks")))]
    arrays = [png.read_mask(m) for m in masks]
    t0 = time.perf_counter()
    blobs = [png.encode_png(a) for a in arrays]
    enc = 1e3 * (time.perf_counter() - t0) / max(1, len(arrays))
    t0 = time.perf_counter()
    for b in blobs:
        png.decode_png(b)
    dec = 1e3 * (time.perf_counter() - t0) / max(1, len(blobs))
    frames = [os.path.join(meta.img_dir("val"), id_to_file[int(i)])
              for i in results]
    t0 = time.perf_counter()
    pixels = [png.read_frame(f) for f in frames]
    frame_dec = 1e3 * (time.perf_counter() - t0) / n
    paeth = png.encode_png(pixels[0][..., ::-1].copy(), filter=4)
    t0 = time.perf_counter()
    png.decode_png(paeth)
    paeth_dec = 1e3 * (time.perf_counter() - t0)
    gt_dir = meta.gt_instance_dir()
    stems = [os.path.basename(f)[:-len(".png")] for f in frames]
    t0 = time.perf_counter()
    gts = {s: png.read_png(os.path.join(gt_dir, "synth", s.replace(
        "leftImg8bit", "gtFine_instanceIds") + ".png")) for s in stems}
    gt_dec = 1e3 * (time.perf_counter() - t0) / n
    preds = load_prediction_dir(out_dir, stems)
    cfg = InstanceEvalConfig()
    t0 = time.perf_counter()
    for s in stems:
        match_image(gts[s], preds[s], cfg)
    match = 1e3 * (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    run_instance_eval(meta, results, out_dir, annotations=ann,
                      gt_instance_dir=gt_dir)
    whole = time.perf_counter() - t0
    print(f"[eval] host, per 2048x1024 frame: rasterize {rast:.1f} ms "
          f"({len(masks)} masks of {n} frames), PNG mask encode {enc:.2f} "
          f"ms / decode {dec:.2f} ms a mask, frame decode {frame_dec:.1f} "
          f"ms (filter None) / {paeth_dec:.1f} ms (Paeth), GT decode "
          f"{gt_dec:.1f} ms, match {match:.2f} ms; run_eval over the split "
          f"{whole:.3f} s ({card})")


def phase_eval(root, card):
    """The polygon instance-AP eval path at full width on a PNG fixture:
    `main` with AP-gated oracle validation, then test.py on its
    model_best (see the module doc, phase 13)."""
    import torch
    from centerpoly_tpu_torch import main as tmain, test as ttest
    from centerpoly_tpu_torch.data.fixture import write_rect_fixture
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.train import checkpoint

    eroot = os.path.join(root, "eval")
    t0 = time.perf_counter()
    write_rect_fixture(eroot, EVAL_FRAMES, SEED + 1, *FRAME_HW,
                       splits=("train", "val"), png=True)
    print(f"[eval] PNG fixture of {EVAL_FRAMES} 2048x1024 frames (train + "
          f"val, 16-bit GT) in {time.perf_counter() - t0:.2f} s")
    zero_counts()
    tr = tmain.main(train_argv(eroot, "off") + ORACLE_ARGS, device="cuda")
    save_dir = os.path.join(eroot, "exp", "cityscapes", "polydet",
                            exp_id("dla_34", "off"))
    with open(os.path.join(save_dir, "instance_ap.json")) as f:
        card_res = json.load(f)
    ap = card_res["allAp"]
    print(f"[eval] main --val_intervals 1, all four oracles: AP {ap!r} "
          f"AP50 {card_res['allAp50%']!r}, best {tr.best!r}")
    check(ap > 0.5, f"oracle AP {ap} <= 0.5")
    check(tr.best == ap, f"model_best gated on {tr.best}, not on AP {ap}")
    check_saved(eroot, "dla_34", "off")
    # the same val batches decoded on the CPU with zero heads: under all
    # four oracles the result depends only on the ground truth
    cpu_results = {}
    for batch in tr.val_loader:
        b = batch["input"].shape[0]
        zero = {k: torch.zeros(b, tr.cfg.output_h, tr.cfg.output_w, c)
                for k, c in tr.cfg.heads.items()}
        cpu_results.update(tr._decode_outputs(zero, batch))
    cpu_res = tr.meta.run_eval(cpu_results, os.path.join(eroot, "cpu_ref"),
                               thresh=tr.cfg.thresh)
    same = (json.dumps(cpu_res, sort_keys=True)
            == json.dumps(card_res, sort_keys=True))
    print(f"[eval] CPU zero-head AP {cpu_res['allAp']!r}: "
          f"{'equal' if same else 'DIFFERENT'}")
    check(same, "oracle AP on the card differs from the CPU's")
    ann = tr.val_loader.sampler.coco
    eval_host_times(tr.meta, cpu_results, ann, os.path.join(eroot, "times"),
                    card)
    del tr
    torch.cuda.empty_cache()

    argv = ["polydet", "--dataset", "cityscapes", "--data_dir", eroot,
            "--save_dir", os.path.join(eroot, "exp"), "--load_model",
            checkpoint.checkpoint_path(save_dir, "best")]
    outs = {}
    for bs in (1, 4):
        zero_counts()
        out = outs[bs] = ttest.main(argv + ["--exp_id", f"test_b{bs}",
                                            "--eval_batch", str(bs)])
        torch.cuda.synchronize()
        counts = dict(dcn.launches)
        forwards = EVAL_FRAMES // bs
        want = dict.fromkeys(counts, 0)
        want["rowband"] = 16 * forwards
        res = out["ap"]
        print(f"[eval] test.py --eval_batch {bs}: {out['frames']} frames, "
              f"run_eval {out['eval_seconds']:.3f} s, AP "
              f"{res and res['allAp']!r}, launches {counts} ({card})")
        check(out["frames"] == EVAL_FRAMES and counts == want,
              f"expected 16 rowband launches a forward, {want}")
        check(res is not None and np.isfinite(res["allAp"])
              and all(os.path.exists(os.path.join(out["save_dir"], f))
                      for f in ("results.json", "instance_ap.json",
                                "gtInstances.json")),
              f"test.py --eval_batch {bs} wrote no AP")
    ds, dc = results_agree(outs[1]["results"], outs[4]["results"])
    print(f"[eval] test.py eval_batch 1 and 4 agree: the same frames and "
          f"classes, the top {EVAL_TOP} rows of each frame found in both "
          f"(largest differences: score {ds:.2e}, box and vertices {dc:.3f} "
          f"px)")
    eval_rates(argv, card)


def results_agree(a, b, what=("eval_batch 1", "eval_batch 4"),
                  score_tol=0.01, px_tol=EVAL_CELL_PX):
    """Check two runs' results (by default test.py's at eval_batch 1, `a`,
    and 4, `b`; `what` names the two runs): the same frames and classes,
    K rows a frame in both, and each of a frame's `EVAL_TOP`
    highest-scoring rows of `a` found in `b` in the same class, its score
    within `score_tol` and its box and vertices within `px_tol` (by
    default one output cell: bf16 nets at two batch sizes run other
    convolution algorithms and DCN splits).  Returns the largest score
    and coordinate differences of the matched rows."""
    check(a.keys() == b.keys(), f"{what[0]} and {what[1]} scored other "
          f"frames")
    ds = dc = 0.0
    for img_id, per in a.items():
        other = b[img_id]
        check(per.keys() == other.keys()
              and sum(map(len, per.values())) == sum(map(len, other.values())),
              f"frame {img_id}: other classes or row counts at {what[1]}")
        rows = [(r[4], cls, np.asarray(r, np.float64))
                for cls, v in per.items() for r in v]
        for score, cls, row in sorted(rows, key=lambda t: -t[0])[:EVAL_TOP]:
            cand = np.asarray(other[cls], np.float64).reshape(-1, len(row))
            d_s = np.abs(cand[:, 4] - score)
            d_c = np.abs(np.delete(cand - row, [4, len(row) - 1], 1)).max(1)
            ok = (d_s <= score_tol) & (d_c <= px_tol)
            check(ok.any(), f"frame {img_id}: a class {cls} row of score "
                  f"{score:.4f} has no counterpart at {what[1]}")
            j = np.flatnonzero(ok)[np.argmin(d_c[ok])]
            ds, dc = max(ds, float(d_s[j])), max(dc, float(d_c[j]))
    return ds, dc


def eval_rates(argv, card):
    """test.py's two detector loops at a steady rate: one detector, warmed
    by an untimed pass over the split, then `EVAL_PASSES` timed passes of
    each loop (frame decode from PNG included, as test.py runs it);
    frames/s of each pass as median, min and max, and at eval_batch 1 the
    stage means that test.py prints for the last pass."""
    import contextlib
    import io
    from centerpoly_tpu_torch import test as ttest

    _, _, _, sampler, det = ttest.setup(argv)
    loops = {1: lambda: ttest._run_single(det, sampler),
             4: lambda: ttest._run_batched(det, sampler, 4)}
    for bs, loop in loops.items():
        log, rates = io.StringIO(), []
        with contextlib.redirect_stdout(log):
            loop()
            for _ in range(EVAL_PASSES):
                t0 = time.perf_counter()
                loop()
                rates.append(len(sampler) / (time.perf_counter() - t0))
        stages = (f", last pass {log.getvalue().splitlines()[-1]}"
                  if bs == 1 else "")
        print(f"[eval] test.py loop, eval_batch {bs}, warm: "
              f"{statistics.median(rates):.3f} frames/s median "
              f"({min(rates):.3f}-{max(rates):.3f}) over {EVAL_PASSES} "
              f"passes of {len(sampler)} frames{stages} ({card})")


DP_WORLD = 2        # ranks of phase 14 (a), sharing the one card
DP_STEPS = 6        # timed data-parallel steps a rank, the first a warm-up


def dp_config(kernel="off"):
    """The training slice's config (512x1024, global batch 4, f32, the v2
    loss), as `main` builds it from `train_argv`."""
    from centerpoly_tpu_torch.configs import Config
    return Config(input_h=512, input_w=1024, batch_size=TRAIN_BATCH,
                  num_workers=0, rep="polar", poly_loss="l1+iou",
                  poly_order=True, lr=2e-4, dcn_kernel=kernel)


def dp_sampler(cfg, root):
    from centerpoly_tpu_torch.data import (CityscapesMeta,
                                           CocoPolyAnnotations,
                                           PolydetSampler)
    meta = CityscapesMeta(root)
    return PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))


def dp_seeded_state(cfg, grad_bucket=False, group=None):
    """The trainer's seeded init on the card (channels_last), its Adam,
    and a train step (data parallel over `group` when one is given)."""
    import torch
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.train import state as tstate
    from centerpoly_tpu_torch.train.step import make_train_step
    from centerpoly_tpu_torch.train.trainer import loss_config_for
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = create_model(cfg.arch, cfg.heads, cfg.head_conv,
                             dcn_kernel=cfg.dcn_kernel)
    model.to("cuda", memory_format=torch.channels_last)
    st = tstate.create_train_state(model, base_lr=cfg.lr)
    return st, make_train_step(loss_config_for(cfg), group=group,
                               grad_bucket=grad_bucket)


def dp_perturb(model):
    """Every weight of `model` moved by a seeded relative 1e-6: the step
    from there measures the net's own sensitivity, the floor under a
    comparison of two gradients."""
    import torch
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen,
                                          device=p.device))


def dp_step(state, step, host):
    """One step of `host` (numpy) on the card with the launch counts zeroed
    just before and read just after: the loss, every gradient, parameter
    and BatchNorm statistic on the host, and the launches."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.train.step import to_device
    batch = to_device(host, torch.device("cuda", torch.cuda.current_device()))
    zero_counts()
    state, stats = step(state, batch)
    torch.cuda.synchronize()
    return {"loss": float(stats["loss"]), "launches": dict(dcn.launches),
            "grads": {n: p.grad.detach().cpu()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().cpu()
                       for n, p in state.model.named_parameters()},
            "bufs": {n: b.detach().cpu() for n, b in
                     state.model.named_buffers()
                     if n.endswith(("running_mean", "running_var"))}}


def dp_grad_errors(got, ref, moved):
    """Per gradient (relative L2 distance of `got` to `ref` past its limit
    4 floor + 1e-3, the distance, the floor, name), the one closest to
    its limit first; the floor is `moved`'s distance to `ref`, the step
    after a 1e-6 weight change.  Tensors whose exact gradient is 0 (DCN
    biases before train-mode BatchNorm: norm under 1e-6 of the largest)
    are left out, as in phase 9."""
    check(got.keys() == ref.keys() == moved.keys(),
          "gradients of other tensors")
    norm = {n: g.double().norm().item() for n, g in ref.items()}
    top = max(norm.values())
    out = []
    for n, r in ref.items():
        if norm[n] < 1e-6 * top:
            continue
        err = (got[n].double() - r.double()).norm().item() / norm[n]
        floor = (moved[n].double() - r.double()).norm().item() / norm[n]
        out.append((err - 4 * floor - 1e-3, err, floor, n))
    return sorted(out, reverse=True)


def _dp_rank(rank, port, root, host, tiled, out):
    """One rank of phase 14 (a): gloo over localhost, on card 0 beside the
    other rank.  The global step as `Trainer` builds it, on this rank's
    half of the global batch; the bucketed step on its half of the tiled
    batch; then DP_STEPS timed global steps.  Writes its results to
    `out`.<rank>."""
    import torch
    import torch.distributed as dist
    from centerpoly_tpu_torch.data import Loader
    from centerpoly_tpu_torch.train.mesh import shard_batch
    from centerpoly_tpu_torch.train.step import to_device
    from centerpoly_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    # a rank that waits this long in a collective fails the phase
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=DP_WORLD,
                            timeout=datetime.timedelta(seconds=180))
    try:
        cfg = dp_config()
        sampler = dp_sampler(cfg, root)
        loader = Loader(sampler, len(sampler), TRAIN_BATCH // DP_WORLD,
                        seed=cfg.seed, rank=rank, world=DP_WORLD)
        tr = Trainer(cfg, loader, device="cuda:0", group=dist.group.WORLD)
        shard = shard_batch(host, rank, DP_WORLD)
        res = {"global": dp_step(tr.state, tr.train_step, shard)}
        st, step = dp_seeded_state(cfg, grad_bucket=True,
                                   group=dist.group.WORLD)
        res["bucket"] = dp_step(st, step, shard_batch(tiled, rank, DP_WORLD))
        del st, step
        # timed with the defaults a training run gets (phase 10's): f32
        # matmuls in full f32, cuDNN convolutions in TF32
        torch.backends.cudnn.allow_tf32 = True
        batch = to_device(shard, "cuda:0")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.state, _ = tr.train_step(tr.state, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        res["p50_ms"] = statistics.median(times[1:])
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

        def one_step():
            tr.state, _ = tr.train_step(tr.state, batch)
        wall_ms, events = profile_events(one_step)
        # the host's time in the collectives: gloo's records of each call
        res["profile"] = (wall_ms, device_rows(events), sorted(
            ((e.cpu_time_total / 1e3, e.count, e.key) for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and "gloo:" in e.key), reverse=True))
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def phase_data_parallel(root, card):
    """Phase 14: the data-parallel slice (train/mesh.py).  (a) two gloo
    ranks sharing the card run the global-batch step, each on half of a
    global batch of 4, against the one-process batch-4 step, and the
    bucketed step on a tiled batch; (b) with two cards or more, `main`
    over NCCL, one process a card, and test.py --infer_devices 2; (c)
    run_batch over two replicas on the one card against one replica.
    Returns {"dp": the launches by kernel that rank 0 counted in its
    global step (every rank's and mode's are checked equal to 16 + 16),
    "sharded": rowband launches of a sharded run_batch}."""
    import torch
    from centerpoly_tpu_torch.data import Loader
    from centerpoly_tpu_torch.train import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dp_config()
    sampler = dp_sampler(cfg, root)
    batch = next(iter(Loader(sampler, len(sampler), TRAIN_BATCH,
                             shuffle=False)))
    host = {k: v for k, v in batch.items() if k != "meta"}
    tiled = {k: np.repeat(v[:1], TRAIN_BATCH, 0) for k, v in host.items()}
    refs, moved = {}, {}
    for mode, b in (("global", host), ("bucket", tiled)):
        st, step = dp_seeded_state(cfg)
        refs[mode] = dp_step(st, step, b)
        st, step = dp_seeded_state(cfg)
        dp_perturb(st.model)
        moved[mode] = dp_step(st, step, b)["grads"]
        del st, step
    torch.cuda.empty_cache()

    out, port = os.path.join(root, "dp_rank"), mesh.free_port()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_dp_rank, args=(port, root, host, tiled, out),
                                nprocs=DP_WORLD)
    dt = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.{r}") for r in range(DP_WORLD)]
    want = dict.fromkeys(refs["global"]["launches"], 0)
    want.update(exact=16, bwd_exact=16)
    for mode, ref in refs.items():
        check(ref["launches"] == want, f"one-process {mode} step launched "
              f"{ref['launches']}, not {want}")
        for r, res in enumerate(ranks):
            got = res[mode]
            d_loss = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
            dp = max(((got["params"][n] - p).abs().max().item(), n)
                     for n, p in ref["params"].items())
            bn = max((rel_max(got["bufs"][n], b), n)
                     for n, b in ref["bufs"].items())
            ge = dp_grad_errors(got["grads"], ref["grads"], moved[mode])
            worst = max(ge, key=lambda t: t[1])
            same = all(torch.equal(got[kind][n], ranks[0][mode][kind][n])
                       for kind in ("grads", "params", "bufs")
                       for n in got[kind])
            print(f"[dp] {mode} step, rank {r} of {DP_WORLD} (gloo, one "
                  f"card, {TRAIN_BATCH // DP_WORLD} samples) against one "
                  f"process at batch {TRAIN_BATCH}: loss {got['loss']:.6f} "
                  f"vs {ref['loss']:.6f} (rel {d_loss:.2e}); gradients rel "
                  f"L2 over {len(ge)} tensors: largest {worst[1]:.2e} "
                  f"(floor {worst[2]:.2e}, {worst[3]}), closest to its "
                  f"limit {ge[0][1]:.2e} (floor {ge[0][2]:.2e}, {ge[0][3]}); "
                  f"params after Adam max |diff| {dp[0]:.2e} ({dp[1]}), "
                  f"BatchNorm stats "
                  f"rel_max {bn[0]:.2e} ({bn[1]}); launches "
                  f"{ {k: v for k, v in got['launches'].items() if v} }")
            check(got["launches"] == want, f"rank {r} {mode} step launched "
                  f"{got['launches']}, not {want}")
            check(d_loss <= 1e-4 and dp[0] <= 2 * cfg.lr + 1e-6,
                  f"rank {r} {mode} step disagrees with one process")
            check(ge[0][0] <= 0 and sum("conv_offset_mask" in t[3]
                                        for t in ge) == 32,
                  f"rank {r} {mode} step's gradient {ge[0][3]} is "
                  f"{ge[0][1]:.2e} from one process's, over 4x its floor "
                  f"{ge[0][2]:.2e} + 1e-3")
            check(bn[0] <= 1e-3,
                  f"rank {r} BatchNorm statistics disagree ({bn[1]})")
            check(same, f"rank {r} {mode} step left other weights or "
                  f"statistics than rank 0")
    for r, res in enumerate(ranks):
        print(f"[dp] rank {r}: global step p50 {res['p50_ms']:.2f} ms over "
              f"{DP_STEPS - 1} steps (batch {TRAIN_BATCH // DP_WORLD} a "
              f"rank, 2 ranks on one card: the collectives' and the "
              f"replica's overhead, not scaling), peak memory "
              f"{res['peak_gib']:.2f} GiB ({card})")
        wall_ms, rows, coll = res["profile"]
        busy = sum(r[0] for r in rows)
        print(f"[dp-profile] rank {r}, one global step: wall {wall_ms:.2f} "
              f"ms, device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f} "
              f"%); host time in gloo collectives (calls): " + ", ".join(
                  f"{k} {ms:.2f} ms ({n})" for ms, n, k in coll))
        for ms, n, key in rows[:6]:
            print(f"[dp-profile] rank {r} {ms:8.3f} ms {n:4d} calls  "
                  f"{key[:90]}")
    print(f"[dp] (a) 2 spawned ranks, 2 + {DP_STEPS} steps each, in "
          f"{dt:.1f} s")

    n_cards = torch.cuda.device_count()
    if n_cards >= 2 and TRAIN_BATCH % n_cards == 0:
        from centerpoly_tpu_torch import main as tmain, test as ttest
        t0 = time.perf_counter()
        ret = tmain.main(train_argv(root, "off", val_intervals=0)
                         + ["--exp_id", "dp_main"])
        save_dir = os.path.join(root, "exp", "cityscapes", "polydet",
                                "dp_main")
        check(ret is None and os.path.isfile(os.path.join(
            save_dir, "model_last.pth")), "main over the cards wrote no "
            "model_last")
        print(f"[dp] (b) main over {n_cards} cards (NCCL, one process a "
              f"card, batch {TRAIN_BATCH // n_cards} each) in "
              f"{time.perf_counter() - t0:.1f} s")
        out = ttest.main(["polydet", "--data_dir", os.path.join(root, "eval"),
                          "--save_dir", os.path.join(root, "exp"),
                          "--exp_id", "dp_test", "--eval_batch", "4",
                          "--infer_devices", "2"])
        check(out["frames"] == EVAL_FRAMES, "test.py --infer_devices 2 "
              "scored other frames")
        print(f"[dp] (b) test.py --infer_devices 2: {out['frames']} frames "
              f"in {out['seconds']:.3f} s")
    else:
        print(f"[dp] (b) not run: {n_cards} card(s); main over NCCL and "
              f"test.py --infer_devices 2 need two or four")
    return {"dp": ranks[0]["global"]["launches"],
            "sharded": phase_sharded_run_batch(card)}


def phase_sharded_run_batch(card):
    """Phase 14 (c): run_batch of 4 frames (bf16, rowband:6) over two
    replicas on the one card: 16 rowband launches a replica; each
    replica's 2 frames within 1e-3 in score and 1 px of one replica's
    run_batch of the same 2 frames (the same batch, so the same
    algorithms), and the 4 frames within `results_agree`'s bounds of one
    replica's batch of 4.  Returns the launches."""
    import torch
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.models import create_model

    cfg = Config()
    cfg.prefer_fast_inference_dcn()
    sd = random_state_dict(create_model(cfg.arch, cfg.heads, cfg.head_conv),
                           SEED)
    frames = [np.random.RandomState(SEED + i).randint(
        0, 256, (*FRAME_HW, 3), dtype=np.uint8) for i in range(4)]
    one = create_detector(cfg, sd)
    two = create_detector(cfg, sd, devices=["cuda:0", "cuda:0"])
    ref4 = one.run_batch(frames)
    ref2 = one.run_batch(frames[:2]) + one.run_batch(frames[2:])
    zero_counts()
    got = two.run_batch(frames)
    torch.cuda.synchronize()
    counts = dict(dcn.launches)
    check(counts["rowband"] == 32 and sum(counts.values()) == 32,
          f"expected 16 rowband launches a replica, got {counts}")

    def by_frame(out):
        return {i: r["results"] for i, r in enumerate(out)}
    ds, dc = results_agree(by_frame(ref2), by_frame(got),
                           ("one replica, 2 frames a call", "two replicas"))
    check(ds <= 1e-3 and dc <= 1.0, f"two replicas moved a score by {ds} "
          f"or a vertex by {dc} px from one replica at the same batch")
    ds4, dc4 = results_agree(by_frame(ref4), by_frame(got),
                             ("one replica, 4 frames", "two replicas"))
    times = {}
    for label, det in (("one replica", one), ("two replicas", two)):
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det.run_batch(frames)
            ts.append(1e3 * (time.perf_counter() - t0))
        times[label] = statistics.median(ts[1:])
    print(f"[dp] (c) run_batch of 4 over [cuda:0, cuda:0]: {counts['rowband']}"
          f" rowband launches (16 a replica); the top {EVAL_TOP} rows of "
          f"each frame against one replica at the same batch of 2: score "
          f"{ds:.2e}, box and vertices {dc:.3f} px; against one replica's "
          f"batch of 4: {ds4:.2e}, {dc4:.3f} px; p50 "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
          + f" for 4 frames ({card})")
    return counts["rowband"]


# ---- phases 17-19: the rest of polydet serving and the convergence
#      harness

VIDEO_FRAMES = 8        # frames of the in-memory capture of phase 17
CSV_SHAPES = [FRAME_HW] * 6 + [(375, 1242)] * 2     # phase 18's frames
CONV_DIR = "convergence"
# DLA-34's DCN node shapes, (H, W, Cin, Cout), at the convergence
# harness's 128x256 input: NODE_SHAPES at a quarter of the height and width
CONV_NODE_SHAPES = [(h // 4, w // 4, cin, cout)
                    for h, w, cin, cout in NODE_SHAPES]


def serving_config(**kw):
    """A Config as the inference CLIs resolve it: rowband:6 on DLA-34."""
    from centerpoly_tpu_torch.configs import Config
    cfg = Config(**kw)
    check(cfg.prefer_fast_inference_dcn() and cfg.dcn_kernel == "rowband:6",
          f"inference default is {cfg.dcn_kernel}, not rowband:6")
    return cfg


def same_results(a, b):
    return set(a) == set(b) and all(
        np.array_equal(np.asarray(a[j]), np.asarray(b[j])) for j in a)


def phase_demo(sd, root, card):
    """Phase 17: the image demo and the video loops on DLA-34 at full
    width, bf16, rowband:6, phase 4's weights.  `demo.main` on a 2048x1024
    PNG with --save_overlay --debug 4 (16 rowband launches): the overlay
    and detections.png read back at frame size, pred_hm.png at the
    network's input size (the JAX package blends the heat map over the
    network input); the host time of `_debug_views` at level 4; then
    `run_video`'s three loops (`video_results`: per frame, batched by 4,
    pipelined) over an in-memory capture of 8 seeded frames, cuDNN on its
    deterministic algorithms: the per-frame and pipelined loops equal to
    `run` frame by frame, the batched one to `run_batch` over the same
    stacks, and in f32 (TF32 off) to `run` within score 1e-3 and 1 px
    (phase 18's bounds); each loop's frames/s, warm."""
    import torch
    from centerpoly_tpu_torch.infer import demo
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.utils.png import read_frame, write_frame

    droot = os.path.join(root, "demo")
    os.makedirs(droot)
    weights = os.path.join(droot, "dla34.pth")
    torch.save({"state_dict": sd}, weights)
    # phase 4's seeded frames (its 4), and more of them
    frames = [np.random.RandomState(SEED + i).randint(
        0, 256, (*FRAME_HW, 3), dtype=np.uint8) for i in range(VIDEO_FRAMES)]
    png = os.path.join(droot, "frame0.png")
    write_frame(png, frames[0])
    debug_dir = os.path.join(droot, "debug")
    zero_counts()
    demo.main(["polydet", "--demo", png, "--load_model", weights,
               "--save_overlay", "--debug", "4", "--debug_dir", debug_dir])
    torch.cuda.synchronize()
    counts = {k: v for k, v in dcn.launches.items() if v}
    check(counts == {"rowband": 16}, f"demo: launches {counts}")
    inp_hw = (FRAME_HW[0] // 2, FRAME_HW[1] // 2)
    for path, hw in ((os.path.join(droot, "frame0_polydet.png"), FRAME_HW),
                     (os.path.join(debug_dir, "detections.png"), FRAME_HW),
                     (os.path.join(debug_dir, "pred_hm.png"), inp_hw)):
        img = read_frame(path)
        check(img.shape == (*hw, 3), f"{path}: {img.shape}, not {hw}")
    print(f"[demo] demo.main --save_overlay --debug 4: 16 rowband launches; "
          f"overlay and detections.png {FRAME_HW[1]}x{FRAME_HW[0]}, "
          f"pred_hm.png {inp_hw[1]}x{inp_hw[0]}")

    det = create_detector(serving_config(debug=4, debug_dir=debug_dir), sd)
    views, spent = det._debug_views, []

    def timed(*args):
        t0 = time.perf_counter()
        views(*args)
        spent.append(1e3 * (time.perf_counter() - t0))

    det._debug_views = timed
    for frame in frames[:4]:
        det.run(frame)
    print(f"[demo] _debug_views at level 4 (compose + 2 PNG writes), host: "
          f"{statistics.median(spent[1:]):.1f} ms median of "
          f"{len(spent) - 1} frames after one warm-up ({card})")

    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    det = create_detector(serving_config(), sd)
    runs = [det.run(f)["results"] for f in frames]
    loops = {"per frame": (1, False), "batched by 4": (4, False),
             "pipelined": (1, True)}
    for label, (batch, stream) in loops.items():
        list(demo.video_results(det, demo.MemoryCapture(frames), batch,
                                stream))
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        got = list(demo.video_results(det, demo.MemoryCapture(frames), batch,
                                      stream))
        torch.cuda.synchronize()
        rate = len(got) / (time.perf_counter() - t0)
        forwards = VIDEO_FRAMES // batch
        check(len(got) == VIDEO_FRAMES
              and dict(dcn.launches)["rowband"] == 16 * forwards
              and sum(dcn.launches.values()) == 16 * forwards,
              f"video loop {label}: {len(got)} frames, launches "
              f"{dict(dcn.launches)}")
        check(all(np.array_equal(img, f) for (img, _), f in zip(got, frames)),
              f"video loop {label}: frames out of order")
        if batch > 1:
            # bf16 at batch 4 runs other convolution algorithms than at 1,
            # and the random net amplifies that (bf16 heads part from f32
            # by ~0.5 of their range, phase 4): held to run_batch over the
            # same stacks here, and to run in f32 below
            stacks = [r["results"] for i in range(0, VIDEO_FRAMES, batch)
                      for r in det.run_batch(frames[i:i + batch])]
            check(all(same_results(r["results"], want)
                      for (_, r), want in zip(got, stacks)),
                  f"video loop {label}: results differ from run_batch's")
            agree = "equal to run_batch's over the same stacks"
        else:
            check(all(same_results(r["results"], want)
                      for (_, r), want in zip(got, runs)),
                  f"video loop {label}: results differ from run()")
            agree = "equal to run's"
        print(f"[demo] video loop {label}: {len(got)} frames, "
              f"{16 * forwards} rowband launches, results {agree}; "
              f"{rate:.3f} frames/s warm ({card})")
    n = demo.run_video(det, demo.MemoryCapture(frames), batch=4)
    check(n == VIDEO_FRAMES, f"run_video served {n} frames")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det32 = create_detector(serving_config(mixed_precision=False), sd)
    got = list(demo.video_results(det32, demo.MemoryCapture(frames), 4))
    ds, dc = results_agree({i: det32.run(f)["results"]
                            for i, f in enumerate(frames)},
                           {i: r["results"] for i, (_, r) in enumerate(got)},
                           ("run", "the batched video loop"), 1e-3, 1.0)
    print(f"[demo] f32 (TF32 off) batched video loop against run: the top "
          f"{EVAL_TOP} rows of each frame found within score 1e-3 and 1 px "
          f"(largest differences: score {ds:.2e}, box and vertices "
          f"{dc:.3f} px)")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
        tf32)
    torch.backends.cudnn.deterministic = flags
    return weights


def csv_rows_agree(a, b, score_tol, px_tol):
    """Two run_on_csv outputs (lists of CSV lines) hold the same rows: each
    row of `a` has its own row of `b` with the same path and label, its
    score within `score_tol` and every integer within `px_tol`.  Returns
    the largest score and integer differences of the matched rows."""
    def parse(lines):
        rows = {}
        for line in lines:
            f = line.split(",")
            rows.setdefault((f[0], f[5]), []).append(
                (float(f[6]), np.array([int(v) for v in f[1:5] + f[7:]])))
        return rows

    ra, rb = parse(a), parse(b)
    check(ra.keys() == rb.keys() and all(len(ra[k]) == len(rb[k])
                                         for k in ra),
          "run_on_csv outputs differ in paths, labels or row counts")
    ds = di = 0.0
    for key, rows in ra.items():
        free = list(rb[key])
        for score, ints in rows:
            cand = [(abs(s - score), np.abs(v - ints).max(), i)
                    for i, (s, v) in enumerate(free)
                    if abs(s - score) <= score_tol
                    and np.abs(v - ints).max() <= px_tol]
            check(bool(cand), f"run_on_csv: a {key} row of score {score} has "
                  f"no counterpart")
            d_s, d_i, i = min(cand, key=lambda c: c[1])
            ds, di = max(ds, d_s), max(di, d_i)
            free.pop(i)
    return ds, int(di)


def phase_run_on_csv(sd, weights, root, card):
    """Phase 18: `run_on_csv.main` over 6 PNG frames at 2048x1024 and 2 at
    1242x375 (a CSV with a repeated path), DLA-34, phase 4's weights:
    bf16 rowband:6 at --eval_batch 1 and 4, the launch counts zeroed
    before each (16 rowband launches a frame at eval_batch 1; at 4, 16 a
    run_batch: 4 + 2 frames of the first shape, then the flush on the
    change of shape, 2 of the second); in f32 (TF32 off) the two runs'
    rows agree to integers within 1 and scores within 1e-3 (bf16 at
    another batch runs other algorithms, which the random net amplifies:
    see phase 17); then frames/s of the
    bf16 serving loop (`serve_csv`, PNG decode included) on a warm
    detector at each batch."""
    import torch
    from centerpoly_tpu_torch.data import CityscapesMeta
    from centerpoly_tpu_torch.infer import run_on_csv
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.utils.png import write_frame

    croot = os.path.join(root, "csv")
    os.makedirs(croot)
    paths = []
    for i, hw in enumerate(CSV_SHAPES):
        path = os.path.join(croot, f"frame{i}.png")
        write_frame(path, np.random.RandomState(SEED + 100 + i).randint(
            0, 256, (*hw, 3), dtype=np.uint8))
        paths.append(path)
    source = os.path.join(croot, "in.csv")
    with open(source, "w") as f:
        f.writelines(f"{p},0,0,10,10,car\n" for p in paths[::-1] + paths[:1])
    base = ["polydet", "--source_csv", source, "--load_model", weights]
    outs, per_frame = {}, None
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype, extra in (("bf16", []), ("f32", ["--no_mixed_precision"])):
        for bs in (1, 4):
            target = os.path.join(croot, f"out_{dtype}_{bs}.csv")
            zero_counts()
            run_on_csv.main(base + extra + ["--eval_batch", str(bs),
                                            "--target_csv", target])
            torch.cuda.synchronize()
            counts = {k: v for k, v in dcn.launches.items() if v}
            forwards = len(paths) if bs == 1 else 3
            if (dtype, bs) == ("bf16", 1):
                per_frame = counts.get("rowband", 0) // len(paths)
            check(counts == {"rowband": 16 * forwards},
                  f"run_on_csv {dtype} eval_batch {bs}: launches {counts}, "
                  f"expected {16 * forwards} rowband")
            with open(target) as f:
                outs[dtype, bs] = f.read().splitlines()
            check(len(outs[dtype, bs]) == 128 * len(paths)
                  and sorted({r.split(",")[0] for r in outs[dtype, bs]})
                  == sorted(paths), f"run_on_csv {dtype} eval_batch {bs}: "
                  f"{len(outs[dtype, bs])} rows")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
        tf32)
    print(f"[csv] run_on_csv bf16 and f32, eval_batch 1 and 4: "
          f"{len(paths)} frames (2 shapes), {128 * len(paths)} rows each, "
          f"16 rowband launches a frame at 1 and a run_batch at 4")
    ds, di = csv_rows_agree(outs["f32", 1], outs["f32", 4], 1e-3, 1)
    print(f"[csv] run_on_csv f32 (TF32 off) eval_batch 1 and 4: rows agree "
          f"(largest differences: score {ds:.2e}, integers {di})")

    det = create_detector(serving_config(), sd)
    names = CityscapesMeta.class_name[1:]
    for bs in (1, 4):
        target = os.path.join(croot, f"rate_{bs}.csv")
        run_on_csv.serve_csv(det, paths, target, bs, names)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = run_on_csv.serve_csv(det, paths, target, bs, names)
        torch.cuda.synchronize()
        print(f"[csv] serve_csv bf16 eval_batch {bs}, warm: "
              f"{n / (time.perf_counter() - t0):.3f} frames/s over {n} "
              f"frames (PNG decode included) ({card})")
    return per_frame


def conv_kernels_vs_plain():
    """Phase 19 (a): the kernels of the dla_34 harness run at its own node
    shapes (`CONV_NODE_SHAPES`, batch 4, f32; the caller turns TF32 off)
    against their plain versions: the forward in `off` (training, validation) and
    rowband:4 (the re-score), relative max within 1e-4 (phase 3's f32
    tolerance), and the backward in `off` within phase 8's f32 ones.
    Returns the largest absolute errors {"exact", "rowband", "bwd_exact"}."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    errs = {"exact": 0.0, "rowband": 0.0, "bwd_exact": 0.0}
    for i, shape in enumerate(CONV_NODE_SHAPES):
        args, g = bwd_inputs(shape, torch.float32, SEED + 200 + i,
                             TRAIN_BATCH)
        for mode, kw in (("exact", {}), ("rowband", BWD_CLAMPS["rowband"])):
            got = dcn.deform_conv2d(*args, **kw)
            ref = dcn.deform_conv2d_ref(*args, **kw)
            torch.cuda.synchronize()
            rel = rel_max(got, ref)
            errs[mode] = max(errs[mode], (got - ref).abs().max().item())
            check(np.isfinite(rel) and rel < 1e-4, f"convergence node "
                  f"b{TRAIN_BATCH} {shape} {mode}: forward rel_max {rel:.3e}")
        worst, _ = check_bwd(f"convergence node b{TRAIN_BATCH} {shape} "
                             f"exact   float32", args, g, {}, 1e-4, 1e-3)
        errs["bwd_exact"] = max(errs["bwd_exact"], worst)
        del args, g
    print(f"[conv] the harness's {len(CONV_NODE_SHAPES)} node shapes "
          f"(batch {TRAIN_BATCH}, f32): forward exact and rowband:{TRAIN_R} "
          f"within 1e-4 of the plain version (max abs {errs['exact']:.2e} / "
          f"{errs['rowband']:.2e}), backward exact within phase 8's bounds "
          f"(max abs {errs['bwd_exact']:.2e})")
    return errs


def stage_launches(fn):
    """Call `fn()` with the launch counts zeroed just before and read just
    after, and the launches split by the stage of the convergence harness
    that made them: `train` (each Trainer.run_epoch), `validate` and
    `re-score` (Trainer.validate in the training mode and in
    rowband:TRAIN_R) and `offsets` (analyze_dcn_offsets.collect).  Returns
    (fn's result, {stage: Counter of launches}, {stage: train or val
    batches, or forwards}, Counter of all the run's launches)."""
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.tools import analyze_dcn_offsets
    from centerpoly_tpu_torch.train.trainer import Trainer

    def validate_stage(tr, *_):
        label = ("re-score" if tr.cfg.dcn_kernel == f"rowband:{TRAIN_R}"
                 else "validate")
        return label, len(tr.val_loader)

    stages = {(Trainer, "run_epoch"):
              lambda tr, *_: ("train", len(tr.train_loader)),
              (Trainer, "validate"): validate_stage,
              (analyze_dcn_offsets, "collect"): lambda *_: ("offsets", 1)}
    counts = collections.defaultdict(collections.Counter)
    batches = collections.Counter()

    def counted(fn, stage):
        def wrapper(*args, **kw):
            before = collections.Counter(dcn.launches)
            out = fn(*args, **kw)
            label, n = stage(*args)
            counts[label] += collections.Counter(dcn.launches) - before
            batches[label] += n
            return out
        return wrapper

    originals = {key: getattr(*key) for key in stages}
    for (owner, name), stage in stages.items():
        setattr(owner, name, counted(originals[owner, name], stage))
    try:
        zero_counts()
        out = fn()
        total = +collections.Counter(dcn.launches)
    finally:
        for (owner, name), orig in originals.items():
            setattr(owner, name, orig)
    return out, counts, batches, total


def phase_convergence(root, card):
    """Phase 19: the oracle-free convergence harness
    (tools/train_convergence.py) on the card, f32 with TF32 off.  (a) the
    kernels at the dla_34 run's node shapes against their plain versions
    (`conv_kernels_vs_plain`).  (b) res_18 with tests/test_convergence.py's
    arguments (cartesian / L1, up to 40 epochs, 8 images at 128x256, batch
    4, lr 2.5e-4, AP every 5 epochs) must reach AP50 >= 0.5 with AP >
    0.15.  (c) dla_34 (cartesian / L1, `off`: the exact CUDA forward and
    backward at every step, up to 60 epochs) must reach AP50 >= 0.5; its
    trained weights are then scored again under rowband:4 (no
    retraining) and their learned offsets measured against R = 4.  The
    dla_34 run's launches are counted by stage (`stage_launches`): 16
    exact forward + 16 exact backward a train step, 16 exact forward a
    val batch, 16 rowband a re-score batch, 16 exact forward for the
    offsets, and no other."""
    import contextlib
    import io
    import torch
    from centerpoly_tpu_torch.tools import train_convergence as tconv

    croot = os.path.join(root, CONV_DIR)
    out = sys.stdout
    common = dict(rep="cartesian", poly_loss="l1", n_images=8, input_h=128,
                  input_w=256, batch_size=4, lr=2.5e-4, bar=0.5,
                  val_every=5, log=lambda msg: print(f"[conv]   {msg}",
                                                     file=out))

    def quiet(**kw):
        """tconv.run with the Trainer's per-epoch lines held back."""
        with contextlib.redirect_stdout(io.StringIO()):
            return tconv.run(**kw, **common)

    # cuDNN on its deterministic algorithms, convolutions and matmuls in
    # f32 (TF32 off, as the phases before leave them and as the JAX
    # harness's f32): the trajectory (and the AP it reaches) repeats from
    # run to run on a card.  With cuDNN's TF32 (the library's training
    # default) res_18 first reaches AP50 0.5348 at epoch 15 with AP 0.1344
    # (H100 80GB HBM3, 700 W): the AP bar is that sensitive (ROADMAP C)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = (True, False, False, False)
    errs = conv_kernels_vs_plain()
    res = quiet(arch="res_18", epochs=40, root=os.path.join(croot, "res"))
    traj = [(t["epoch"], round(t["ap"], 4), round(t["ap50"], 4))
            for t in res["ap_trajectory"]]
    print(f"[conv] res_18: AP50 {res['final_ap50']!r} AP {res['final_ap']!r} "
          f"after {res['steps']} steps, {res['wall_s']} s wall; trajectory "
          f"(epoch, AP, AP50) {traj} ({card})")
    check(res["passed"] and res["final_ap"] > 0.15,
          f"res_18 did not converge: AP50 {res['final_ap50']}, AP "
          f"{res['final_ap']}")
    res, counts, batches, total = stage_launches(lambda: quiet(
        arch="dla_34", epochs=60, root=os.path.join(croot, "dla"),
        eval_dcn=f"rowband:{TRAIN_R}", offset_r=TRAIN_R))
    traj = [(t["epoch"], round(t["ap"], 4), round(t["ap50"], 4))
            for t in res["ap_trajectory"]]
    worst = max(res["offset_stats"], key=lambda r: r["y_frac_clamped_at_r"])
    print(f"[conv] dla_34 (off): AP50 {res['final_ap50']!r} AP "
          f"{res['final_ap']!r} after {res['steps']} steps, {res['wall_s']} s "
          f"wall; trajectory (epoch, AP, AP50) {traj}; the same weights "
          f"under rowband:{TRAIN_R}: AP50 {res['eval_dcn_ap50']!r} (delta "
          f"{res['eval_dcn_ap50_delta']:+.6f}), AP {res['eval_dcn_ap']!r}; "
          f"offsets: worst node {worst['node']} y_frac_clamped_at_r "
          f"{res['worst_node_frac_y_clamped']} (y_p99 {worst['y_p99']}, "
          f"y_max {worst['y_max']}) ({card})")
    check(res["passed"], f"dla_34 did not converge: AP50 "
          f"{res['final_ap50']}")
    launches = check_stage_launches(res, counts, batches, total,
                                    common["n_images"] // common["batch_size"])
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags
    torch.cuda.empty_cache()
    return {**launches, "errs": errs}


def check_stage_launches(res, counts, batches, total, val_batches):
    """Check the launches of a dla_34 harness run by stage
    (`stage_launches`): 16 exact forward + 16 exact backward a train step,
    16 exact forward a val batch (`val_batches` a validation), 16 rowband
    a re-score batch (one validation), 16 exact forward for the offsets,
    and nothing else in the whole run.  Returns {"step": launches a train
    step by kind, "run": the whole run's, "rescore": the re-score's}."""
    steps, C = batches["train"], collections.Counter
    want = {"train": C(exact=16 * steps, bwd_exact=16 * steps),
            "validate": C(exact=16 * batches["validate"]),
            "re-score": C(rowband=16 * batches["re-score"]),
            "offsets": C(exact=16)}
    print(f"[conv] dla_34 run's launches by stage (batches): "
          + "; ".join(f"{k} ({batches[k]}) {dict(v)}"
                      for k, v in counts.items())
          + f"; the whole run {dict(total)}")
    check(steps == res["steps"] > 0 and batches["re-score"] == val_batches
          and batches["validate"] == val_batches * len(res["ap_trajectory"])
          and dict(counts) == want and total == sum(want.values(), C()),
          f"dla_34 harness launches {dict(counts)} (batches "
          f"{dict(batches)}), whole run {dict(total)}: expected {want}")
    return {"step": {k: counts["train"][k] // steps
                     for k in ("exact", "bwd_exact")},
            "run": dict(total), "rescore": counts["re-score"]["rowband"]}


def conv_fields(conv, mode):
    """The kernels line's fields of phase 19 for one kernel (`mode` a key
    of the launch counts)."""
    return {"convergence_dla34_train_step_launches": conv["step"][mode],
            "convergence_dla34_run_launches": conv["run"][mode],
            "convergence_nodes_f32_max_abs_err": conv["errs"][mode]}


# ---- phase 20: the ctdet task ------------------------------------------

# ctdet's network inputs: COCO (and UA-DETRAC) 512x512, KITTI 384x1280
CTDET_INPUTS = {"coco": (512, 512), "kitti": (384, 1280)}
CTDET_FRAME_HW = (480, 640)     # a COCO image
CTDET_SPLITS = {"train": 8, "val": 4}
# a few of COCO's _valid_ids (person, bicycle, car, dog, bottle) and the
# Pascal and KITTI classes they remap to for phase 20 (d)
CTDET_IDS = (1, 2, 3, 18, 44)
CTDET_TO_PASCAL = {1: 15, 2: 2, 3: 7, 18: 12, 44: 5}
CTDET_TO_KITTI = {1: 1, 3: 2, 2: 3}         # Pedestrian, Car, Cyclist


def dla_node_shapes(h, w):
    """{(H, W, Cin, Cout): count} of DLA-34's 16 DCN nodes at an (h, w)
    input: NODE_SHAPES' maps (at 512x1024) scaled to it."""
    return {(h * nh // 512, w * nw // 1024, cin, cout): n
            for (nh, nw, cin, cout), n in NODE_SHAPES.items()}


def phase_ctdet_kernels():
    """Phase 20 (a): both kernels at the distinct DCN node shapes of a
    512x512 (COCO) and a 384x1280 (KITTI) input (12-row and 12-column maps
    at stride 32, 40- and 320-wide maps, square maps), against the plain
    versions with phase 3's and phase 8's bounds: the forward in bf16 at
    batch 1 and f32 at batch 4 in exact / rowband:6 / halo:4, the backward
    in f32 at batch 4 in exact / rowband:4 / halo:4.  Then the bf16 forward
    at each input's nodes by CUDA graph replay in each mode, beside the
    plain version and `node_bound_ms`, summed over a frame's 16 nodes.
    Returns {"fwd_err" | "bwd_err": {mode: max |err|}, "times": {input:
    {"frame": {mode: {"ms", "plain_ms"}}, "bound_ms", "bound_by"}},
    "shapes": {input: node shapes}}."""
    import torch
    from centerpoly_tpu_torch.kernels import dcn
    torch.backends.cuda.matmul.allow_tf32 = False
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tols = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    nodes = {k: dla_node_shapes(*hw) for k, hw in CTDET_INPUTS.items()}
    shapes = sorted(set(nodes["coco"]) | set(nodes["kitti"]))
    fwd_err = dict.fromkeys(FWD_CLAMPS, 0.0)
    bwd_err = dict.fromkeys(BWD_CLAMPS, 0.0)
    for i, shape in enumerate(shapes):
        for batch, dtype in ((1, torch.bfloat16), (TRAIN_BATCH, torch.float32)):
            args = node_inputs(shape, dtype, SEED + 200 + i, batch)
            for mode, kw in FWD_CLAMPS.items():
                got = dcn.deform_conv2d(*args, **kw)
                ref = dcn.deform_conv2d_ref(*args, **kw)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs().max().item()
                rel = diff / ref.float().abs().max().item()
                print(f"[ctdet-kernel] b{batch} {shape} {mode:7s} "
                      f"{str(dtype)[6:]:8s} splits "
                      f"{fwd_splits(shape, batch, dtype):2d} max_abs "
                      f"{diff:.3e} rel_max {rel:.3e} (tol {tols[dtype]:g})")
                check(np.isfinite(rel) and rel < tols[dtype],
                      f"kernel disagrees at b{batch} {shape} {mode} {dtype}")
                if dtype == torch.bfloat16:
                    fwd_err[mode] = max(fwd_err[mode], diff)
            del args
        args, g = bwd_inputs(shape, torch.float32, SEED + 200 + i, TRAIN_BATCH)
        plan = dcn.bwd_plan(TRAIN_BATCH * shape[0] * shape[1], *shape[2:],
                            n_sm)
        for mode, kw in BWD_CLAMPS.items():
            worst, _ = check_bwd(
                f"ctdet b{TRAIN_BATCH} {shape} {mode:7s} float32 splits "
                f"{plan.splits}/{plan.data_splits}", args, g, kw, 1e-4, 1e-3)
            bwd_err[mode] = max(bwd_err[mode], worst)
        del args, g
    frames = {}
    for key, hw in CTDET_INPUTS.items():
        frame = {m: {"ms": 0.0, "plain_ms": 0.0} for m in FWD_CLAMPS}
        bound_frame, ops_share = 0.0, 0.0
        for i, (shape, n) in enumerate(nodes[key].items()):
            args = node_inputs(shape, torch.bfloat16, SEED + i)
            bound, by = node_bound_ms(shape)
            bound_frame += n * bound
            ops_share += n * bound * (by == "operations")
            for mode, t in mode_times(*fwd_fns(args), FWD_CLAMPS, 20,
                                      5).items():
                frame[mode]["ms"] += n * t["ms"]
                frame[mode]["plain_ms"] += n * t["plain_ms"]
                print(f"[ctdet-time] {shape} x{n} {mode:7s} kernel "
                      f"{t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
                      f"bound {bound:.4f} ms ({by}, "
                      f"{100 * bound / t['ms']:.1f} % of it)  splits "
                      f"{fwd_splits(shape, 1, torch.bfloat16)}")
            del args
        for mode, v in frame.items():
            print(f"[ctdet-time] {mode} per {hw[0]}x{hw[1]} frame (16 "
                  f"nodes, bf16): kernel {v['ms']:.3f} ms  plain "
                  f"{v['plain_ms']:.3f} ms  bound {bound_frame:.4f} ms "
                  f"({100 * bound_frame / v['ms']:.1f} % of it)")
        frames[key] = {"frame": frame, "bound_ms": bound_frame,
                       "bound_by": ("operations" if ops_share
                                    >= bound_frame / 2 else "bytes")}
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "times": frames,
            "shapes": {k: [list(s) for s in v] for k, v in nodes.items()}}


def ctdet_frames(root):
    """The ctdet fixture's val frames (480x640 uint8) and image ids."""
    from centerpoly_tpu_torch.data import CocoMeta, CocoPolyAnnotations
    meta = CocoMeta(root)
    ann = CocoPolyAnnotations(meta.annot_path("val"))
    ids = ann.get_img_ids()
    return ids, [np.load(os.path.join(meta.img_dir("val"),
                                      ann.load_img(i)["file_name"]))
                 for i in ids]


def phase_ctdet_infer(root):
    """Phase 20 (b): `create_detector(serving_config(task="ctdet",
    dataset="coco"))` at full width (80 classes, head_conv 256, 512x512
    input, heads hm 80 / wh 2 / reg 2, K 128, bf16, rowband:6), seeded
    random weights, on the fixture's 480x640 val frames: `run` and
    `run_batch` of 4 with the launch counts zeroed just before and read
    just after (16 `dcn_fwd[rowband]` a forward, at the 512x512 node
    shapes), `run_stream` equal to `run` frame by frame (cuDNN
    deterministic for both), run p50 and run_batch frames/s
    (`e2e_times`); f32 heads on the card (TF32 off) within 2e-3 of the
    port on the CPU.  Returns ({img_id: run's results}, launches a
    frame)."""
    import torch
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.models.deform_conv import DCNv2

    cfg = serving_config(task="ctdet", dataset="coco")
    check((cfg.input_h, cfg.input_w, cfg.head_conv, cfg.num_classes)
          == (*CTDET_INPUTS["coco"], 256, 80)
          and cfg.heads == {"hm": 80, "wh": 2, "reg": 2}, "ctdet config")
    sd = random_state_dict(create_model(cfg.arch, cfg.heads, cfg.head_conv),
                           SEED + 20)
    ids, frames = ctdet_frames(root)
    det = create_detector(cfg, sd)
    check(det.device.type == "cuda" and det.dtype == torch.bfloat16,
          f"detector on {det.device} in {det.dtype}")
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(
            (*inp[0].shape[2:], inp[0].shape[1], out.shape[1])))
        for m in det.model.modules() if isinstance(m, DCNv2)]
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    for i, frame in zip(ids, frames):
        ret, n = run_counted(lambda: det.run(frame), "rowband")
        runs[i] = ret["results"]
        rows = np.concatenate([np.asarray(v) for v in ret["results"].values()])
        check(rows.shape == (cfg.K, 5) and np.isfinite(rows).all(),
              f"ctdet frame {i} results {rows.shape}")
    for h in hooks:
        h.remove()
    want = dla_node_shapes(*CTDET_INPUTS["coco"])
    check(collections.Counter(shapes[:16]) == collections.Counter(want),
          f"ctdet DCN node shapes {collections.Counter(shapes[:16])}")
    batch, nb = run_counted(lambda: det.run_batch(frames), "rowband")
    check(len(batch) == len(frames), "run_batch returned the wrong count")
    zero_counts()
    streamed = list(det.run_stream(iter(frames), depth=2))
    counts = {k: v for k, v in dcn.launches.items() if v}
    torch.backends.cudnn.deterministic = flags
    check(counts == {"rowband": 16 * len(frames)},
          f"run_stream launches {counts}")
    for i, got in zip(ids, streamed):
        check(same_results(got, runs[i]), f"run_stream frame {i} differs "
              f"from run()")
    print(f"[ctdet] bf16 rowband:6 on {len(frames)} {CTDET_FRAME_HW[1]}x"
          f"{CTDET_FRAME_HW[0]} frames: run {n} dcn_fwd launches a frame at "
          f"the 512x512 node shapes, run_batch of {len(frames)} {nb}, "
          f"run_stream equal to run frame by frame; {cfg.K} finite rows")
    e2e_times(det, "ctdet rowband:6", frames)
    del det

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = serving_config(task="ctdet", dataset="coco",
                           mixed_precision=False)
    det32 = create_detector(cfg32, sd)
    det_cpu = create_detector(cfg32, sd, device="cpu")
    trans, meta = det_cpu._scaled_trans(*CTDET_FRAME_HW, 1.0)
    with torch.no_grad():
        x = det_cpu._pre_device(torch.from_numpy(frames[0])[None], trans,
                                (meta["inp_h"], meta["inp_w"]))
        ref = det_cpu._heads(x)
        got = det32._heads(x.to("cuda", memory_format=torch.channels_last))
    check_heads("ctdet 512x512", ref, got)
    return runs, n


def ctdet_train_argv(root, *extra):
    return ["ctdet", "--dataset", "coco", "--data_dir", root, "--save_dir",
            os.path.join(root, "exp"), "--exp_id", "ctdet", *extra]


def phase_ctdet_train(root):
    """Phase 20 (c): `main ctdet` on the COCO box fixture for one epoch
    (batch 4, 512x512, f32, `off`: 16 exact forward + 16 backward launches
    a step) with `--val_intervals 1`: the loss finite and falling on a
    fixed batch, coco_eval.json with every key, model_best; one more step
    with the launch counts zeroed just before and read just after; step
    p50, images/s and peak memory; test.py on model_best in the same
    arithmetic (f32, `off`): its AP and AP50 those of main's validation;
    `train_vs_cpu` of a ctdet step in `off`.  Returns the counts of one
    step by kernel."""
    import torch
    from centerpoly_tpu_torch import main as tmain
    from centerpoly_tpu_torch import test as ttest
    from centerpoly_tpu_torch.kernels import dcn

    zero_counts()
    tr = tmain.main(ctdet_train_argv(
        root, "--batch_size", str(TRAIN_BATCH), "--num_workers", "0",
        "--num_epochs", "1", "--val_intervals", "1", "--dcn_kernel", "off"),
        device="cuda")
    torch.cuda.synchronize()
    counts = {k: v for k, v in dcn.launches.items() if v}
    steps, n_val = tr.state.step, len(tr.val_loader)
    print(f"[ctdet-train] main ctdet --dcn_kernel off: {steps} steps of batch "
          f"{TRAIN_BATCH} at {tr.cfg.input_h}x{tr.cfg.input_w} + {n_val} val "
          f"batches; launches {counts}")
    check((tr.cfg.input_h, tr.cfg.input_w) == CTDET_INPUTS["coco"]
          and steps == 2 and n_val == 1
          and counts == {"exact": 16 * (steps + n_val),
                         "bwd_exact": 16 * steps},
          "expected 16 forward + 16 backward launches a step")
    save_dir = os.path.join(root, "exp", "coco", "ctdet", "ctdet")
    with open(os.path.join(save_dir, "coco_eval.json")) as f:
        main_ap = json.load(f)
    check(set(main_ap) == {"AP", "AP50", "AP75", "AR100", "APs", "APm",
                           "APl"} and all(np.isfinite(list(main_ap.values()))),
          f"coco_eval.json {main_ap}")
    check(os.path.isfile(os.path.join(save_dir, "model_best.pth")),
          "no model_best.pth after main ctdet")
    print(f"[ctdet-train] main's validation: coco_eval.json {main_ap}")
    loss_falls(tr, "ctdet off")
    step = step_launches(tr, 16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    step_times(tr, "ctdet off")
    del tr
    torch.cuda.empty_cache()

    out = ttest.main(ctdet_train_argv(
        root, "--load_model", os.path.join(save_dir, "model_best.pth"),
        "--dcn_kernel", "off", "--no_mixed_precision"), device="cuda")
    check(out["frames"] == CTDET_SPLITS["val"] and out["ap"] is not None
          and (out["ap"]["AP"], out["ap"]["AP50"])
          == (main_ap["AP"], main_ap["AP50"]),
          f"test.py AP {out['ap']} differs from main's {main_ap}")
    print(f"[ctdet-train] test.py on model_best (f32, off): AP "
          f"{out['ap']['AP']} AP50 {out['ap']['AP50']}, main's validation's")
    train_vs_cpu(root, "dla_34", "off", "exact", task="ctdet")
    return step


def phase_ctdet_evaluators(root, runs):
    """Phase 20 (d): (b)'s detections on the fixture's val frames, their
    COCO classes remapped to Pascal's (CTDET_TO_PASCAL), scored by
    `PascalMeta.run_eval` against the fixture's boxes in the Pascal layout
    (VOC-07 and the COCO-protocol file); remapped to KITTI's classes
    (CTDET_TO_KITTI), written as KITTI-2D rows by `Kitti2dMeta` and scored
    by `run_kitti_eval` against KITTI label files of the same boxes; then
    the fixture's own boxes through both, which must score VOC-07 mAP 1 and
    a KITTI AP above 0.  The native evaluator builds at first use into
    centerpoly_tpu_torch/_build/native; it must build."""
    from centerpoly_tpu_torch.data import (CocoMeta, CocoPolyAnnotations,
                                           Kitti2dMeta, PascalMeta)
    from centerpoly_tpu_torch.eval import native

    coco = CocoMeta(root)
    ann = CocoPolyAnnotations(coco.annot_path("val"))
    pascal = PascalMeta(root)
    voc = dict(ann.dataset, annotations=[
        dict(a, category_id=CTDET_TO_PASCAL[a["category_id"]])
        for a in ann.dataset["annotations"]])
    os.makedirs(os.path.dirname(pascal.annot_path("val")), exist_ok=True)
    with open(pascal.annot_path("val"), "w") as f:
        json.dump(voc, f)

    def remap(table, results):
        out = {}
        for img_id, per_class in results.items():
            out[img_id] = {}
            for j, rows in per_class.items():
                c = table.get(coco._valid_ids[j - 1])
                if c is not None and len(rows):
                    out[img_id][c] = np.concatenate(
                        [out[img_id].get(c, np.zeros((0, 5), np.float32)),
                         np.asarray(rows, np.float32)])
        return out

    # the fixture's own boxes as detections (score 0.9): the evaluators
    # must see the GT (VOC-07 mAP 1, KITTI AP > 0), so a 0 from the card's
    # random weights is theirs, not the evaluators'
    gt_rows = {}
    for img_id in ann.get_img_ids():
        gt_rows[img_id] = {}
        for a in ann.load_anns(img_id):
            x, y, w, h = a["bbox"]
            j = coco.cat_ids[a["category_id"]] + 1
            gt_rows[img_id][j] = np.concatenate([gt_rows[img_id].get(
                j, np.zeros((0, 5), np.float32)), np.array(
                    [[x, y, x + w, y + h, 0.9]], np.float32)])

    kitti = Kitti2dMeta(root)
    gt_dir = os.path.join(root, "kitti_label_2")
    os.makedirs(gt_dir, exist_ok=True)
    for img_id in ann.get_img_ids():
        with open(os.path.join(gt_dir, f"{img_id:06d}.txt"), "w") as f:
            for a in ann.load_anns(img_id):
                c = CTDET_TO_KITTI.get(a["category_id"])
                if c is None:
                    continue
                x, y, w, h = a["bbox"]
                f.write(f"{kitti.class_name[c]} 0.00 0 -10 {x:.2f} {y:.2f} "
                        f"{x + w:.2f} {y + h:.2f} -1 -1 -1 -1000 -1000 -1000 "
                        f"-10\n")
    t0 = time.perf_counter()
    built = native.ensure_built()
    check(built, f"the native evaluator did not build: "
          f"{native.last_build_error}")
    print(f"[ctdet-eval] cpp/ built into {os.path.relpath(native.BUILD_DIR)} "
          f"in {time.perf_counter() - t0:.1f} s")

    for label, results in (("the card's detections", runs),
                           ("the fixture's boxes", gt_rows)):
        tag = "card" if results is runs else "gt"
        voc_dir = os.path.join(root, "exp", f"pascal_{tag}")
        res = pascal.run_eval(remap(CTDET_TO_PASCAL, results), voc_dir)
        check(res["protocol"] == "voc07_11point" and np.isfinite(res["AP"])
              and os.path.isfile(os.path.join(voc_dir, "voc_eval.json"))
              and os.path.isfile(os.path.join(voc_dir,
                                              "coco_protocol_eval.json")),
              f"PascalMeta.run_eval {res}")
        kres = kitti.run_eval(remap(CTDET_TO_KITTI, results), os.path.join(
            root, "exp", f"kitti2d_{tag}"), gt_label_dir=gt_dir)
        check(kres is not None and all(
            np.isfinite(v).all() for per in kres.values()
            for v in per.values()), f"run_kitti_eval {kres}")
        if results is gt_rows:
            check(abs(res["AP"] - 1.0) < 1e-9 and kres and all(
                per["detection"][0] > 0 for per in kres.values()),
                f"the GT as detections: VOC {res['AP']}, KITTI {kres}")
        print(f"[ctdet-eval] {label}: PascalMeta.run_eval VOC-07 mAP "
              f"{res['AP']} (" + " ".join(
                  f"{k[3:]} {v:.4f}" for k, v in res.items()
                  if k.startswith("AP_")) + "), coco_protocol_eval.json "
              f"written; as Kitti2dMeta rows, run_kitti_eval 2D AP " + "; ".join(
                  f"{cls} {per['detection']}" for cls, per in kres.items()
                  if "detection" in per))


def phase_ctdet(root):
    """Phase 20: the ctdet task (see the module doc).  Returns the fields
    of the kernels line."""
    from centerpoly_tpu_torch.data.fixture import write_box_fixture
    t0 = time.perf_counter()
    kern = phase_ctdet_kernels()
    root = write_box_fixture(os.path.join(root, "ctdet"), CTDET_SPLITS,
                             SEED, *CTDET_FRAME_HW,
                             categories=CTDET_IDS)
    runs, run_launches = phase_ctdet_infer(root)
    step = phase_ctdet_train(root)
    phase_ctdet_evaluators(root, runs)
    print(f"[ctdet] phase 20 in {time.perf_counter() - t0:.1f} s")
    return dict(kern, run=run_launches, step=step)


# ---- phases 21 and 22: the exdet and multi_pose tasks ----------------------

# each task's dataset, its phase number and the seed offset of its weights
TASK_DATASETS = {"exdet": "coco", "multi_pose": "coco_hp"}
TASK_PHASES = {"exdet": 21, "multi_pose": 22}


def task_frames(root, dataset):
    """A fixture's val frames (480x640 uint8) and image ids."""
    from centerpoly_tpu_torch.data import DATASETS, CocoPolyAnnotations
    meta = DATASETS[dataset](root)
    ann = CocoPolyAnnotations(meta.annot_path("val"))
    ids = ann.get_img_ids()
    return ids, [np.load(os.path.join(meta.img_dir("val"),
                                      ann.load_img(i)["file_name"]))
                 for i in ids]


def decode_times(task, det, frames):
    """The task's decode alone (exdet: `exct_decode` at k = min(K, 40),
    num_dets K; multi_pose: `multi_pose_decode` with the joint snap at K)
    on the sigmoid maps of a bf16 forward, on the card: device ms by CUDA
    events over 20 calls (after 3) at batch 1 and at the batch of
    run_batch, and the memory it allocates above its inputs at each."""
    import torch
    from centerpoly_tpu_torch.ops.decode import exct_decode, multi_pose_decode
    cfg = det.cfg
    trans, meta = det._scaled_trans(*frames[0].shape[:2], 1.0)
    with torch.no_grad():
        x = det._pre_device(torch.from_numpy(np.stack(frames)).cuda(), trans,
                            (meta["inp_h"], meta["inp_w"]))
        heads = det._heads(x)
    out = {k: v.float().permute(0, 2, 3, 1) for k, v in heads.items()}
    res = {}
    for b in (1, len(frames)):
        o = {k: v[:b] for k, v in out.items()}
        if task == "exdet":
            heats = [torch.sigmoid(o[f"hm_{p}"]) for p in "tlbrc"]
            regs = [o[f"reg_{p}"] for p in "tlbr"]

            def fn():
                return exct_decode(*heats, *regs, k=min(cfg.K, 40),
                                   num_dets=cfg.K)
        else:
            args = (torch.sigmoid(o["hm"]), o["wh"], o["hps"], o["reg"],
                    torch.sigmoid(o["hm_hp"]), o["hp_offset"])

            def fn():
                return multi_pose_decode(*args, k=cfg.K)
        with torch.no_grad():
            ms = cuda_ms(fn, 3, 20)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        res[b] = {"ms": ms, "mib": mib}
        what = (f"exct_decode, k {min(cfg.K, 40)}: {min(cfg.K, 40) ** 4} "
                f"lattice cells an image" if task == "exdet"
                else f"multi_pose_decode, K {cfg.K}")
        print(f"[{task}] decode alone at batch {b} ({what}): {ms:.3f} ms "
              f"device time, {mib:.1f} MiB allocated above its inputs")
    return res


def phase_task_infer(task, root):
    """Phases 21 (a) and 22 (a): `create_detector(serving_config(task,
    dataset))` at full width (DLA-34, head_conv 256, 512x512 input, K 128,
    bf16, rowband:6), seeded random weights, on the fixture's 480x640 val
    frames: `run` with the launch counts zeroed just before and read just
    after (16 `dcn_fwd[rowband]` a frame), one `run` under flip_test
    (exdet: a batch of 1 and the plain run's results, flip_tta off;
    multi_pose: a doubled batch, still 16 launches), `run_batch` of 4 (16),
    `run_stream` equal to `run` frame by frame (cuDNN deterministic), run
    p50 and run_batch frames/s (`e2e_times`), the decode's own device
    time (`decode_times`); then in f32 (TF32 off) the heads on the card
    within 2e-3 of the port on the CPU and the results within score 1e-3
    and 1 px of the CPU's (`results_agree`, two frames; multi_pose also
    under flip_test, exdet also with agnostic_ex, whose random weights
    give rows).  Returns (launches a frame, `decode_times`)."""
    import torch
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.models import create_model

    dataset = TASK_DATASETS[task]
    cfg = serving_config(task=task, dataset=dataset)
    check((cfg.input_h, cfg.input_w, cfg.head_conv)
          == (*CTDET_INPUTS["coco"], 256), f"{task} config")
    print(f"[{task}] heads {cfg.heads}")
    sd = random_state_dict(create_model(cfg.arch, cfg.heads, cfg.head_conv),
                           SEED + TASK_PHASES[task])
    ids, frames = task_frames(root, dataset)
    det = create_detector(cfg, sd)
    check(det.device.type == "cuda" and det.dtype == torch.bfloat16,
          f"detector on {det.device} in {det.dtype}")
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    for i, frame in zip(ids, frames):
        ret, n = run_counted(lambda: det.run(frame), "rowband")
        runs[i] = ret["results"]
        for rows in ret["results"].values():
            check(np.isfinite(rows).all(), f"{task} frame {i}: not finite")
    width = {"exdet": 5, "multi_pose": 39}[task]
    counts = [sum(map(len, r.values())) for r in runs.values()]
    check(all(r.shape[1] == width for v in runs.values() for r in v.values()
              if len(r)), f"{task} rows are not {width} wide")
    det_f = create_detector(serving_config(task=task, dataset=dataset,
                                           flip_test=True), sd)
    batches = []
    hook = det_f.model.register_forward_pre_hook(
        lambda mod, args: batches.append(args[0].shape[0]))
    ret_f, n_f = run_counted(lambda: det_f.run(frames[0]), "rowband")
    hook.remove()
    check(batches == [2 if task == "multi_pose" else 1],
          f"{task} flip_test ran batches {batches}")
    if task == "exdet":
        check(same_results(ret_f["results"], runs[ids[0]]),
              "exdet under flip_test differs from the plain run")
    del det_f
    batch, nb = run_counted(lambda: det.run_batch(frames), "rowband")
    check(len(batch) == len(frames), "run_batch returned the wrong count")
    zero_counts()
    streamed = list(det.run_stream(iter(frames), depth=2))
    counts_s = {k: v for k, v in dcn.launches.items() if v}
    torch.backends.cudnn.deterministic = flags
    check(counts_s == {"rowband": 16 * len(frames)},
          f"run_stream launches {counts_s}")
    for i, got in zip(ids, streamed):
        check(same_results(got, runs[i]), f"{task} run_stream frame {i} "
              f"differs from run()")
    print(f"[{task}] bf16 rowband:6 on {len(frames)} {CTDET_FRAME_HW[1]}x"
          f"{CTDET_FRAME_HW[0]} frames: run {n} dcn_fwd launches a frame, "
          f"under flip_test {n_f} on a batch of {batches[0]}, run_batch of "
          f"{len(frames)} {nb}, run_stream equal to run; rows a frame "
          f"{counts}")
    e2e_times(det, f"{task} rowband:6", frames)
    dec = decode_times(task, det, frames)
    del det

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # exdet's 80-class lattice finds no four peaks of one class in order on
    # random weights (no rows): its results are also held with the
    # class-agnostic edge maps (agnostic_ex), which give rows on frames of
    # uniform noise (on the fixture's dark frames they give none either)
    variants = {"multi_pose": [{}, {"flip_test": True}],
                "exdet": [{}, {"agnostic_ex": True}]}[task]
    for kw in variants:
        cfg32 = serving_config(task=task, dataset=dataset,
                               mixed_precision=False, **kw)
        if kw.get("agnostic_ex"):
            sd = random_state_dict(create_model(
                cfg32.arch, cfg32.heads, cfg32.head_conv),
                SEED + TASK_PHASES[task])
        det32 = create_detector(cfg32, sd)
        det_cpu = create_detector(cfg32, sd, device="cpu")
        tag = "".join(f" {k}" for k in kw)
        if not kw:
            trans, meta = det_cpu._scaled_trans(*CTDET_FRAME_HW, 1.0)
            with torch.no_grad():
                x = det_cpu._pre_device(torch.from_numpy(frames[0])[None],
                                        trans, (meta["inp_h"], meta["inp_w"]))
                ref = det_cpu._heads(x)
                got = det32._heads(x.to("cuda",
                                        memory_format=torch.channels_last))
            check_heads(f"{task} 512x512", ref, got)
        cmp = frames[:2]
        if kw.get("agnostic_ex"):
            cmp = [np.random.RandomState(SEED + i).randint(
                0, 256, (*CTDET_FRAME_HW, 3), dtype=np.uint8) for i in (0, 1)]
        card = {i: det32.run(f)["results"] for i, f in enumerate(cmp)}
        cpu = {i: det_cpu.run(f)["results"] for i, f in enumerate(cmp)}
        ds, dc = results_agree(card, cpu, (f"the card{tag}", f"the CPU{tag}"),
                               score_tol=1e-3, px_tol=1.0)
        rows = [sum(map(len, r.values())) for r in card.values()]
        check(min(rows) > 0 or (task, kw) == ("exdet", {}),
              f"{task}{tag}: no rows to compare")
        print(f"[{task}] f32{tag}: rows a frame {rows}, the best {EVAL_TOP} "
              f"of each within score {ds:.2e} and {dc:.2e} px of the CPU's")
        del det32, det_cpu
    return n, dec


def loader_ms(loader) -> float:
    """Host ms a batch over one pass of a loader (num_workers 0: the
    sampler's own time)."""
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return 1e3 * (time.perf_counter() - t0) / n


def task_argv(task, root, *extra):
    return [task, "--dataset", TASK_DATASETS[task], "--data_dir", root,
            "--save_dir", os.path.join(root, "exp"), *extra]


def phase_task_train(task, root):
    """Phases 21 (b) and 22 (b): `main <task>` on the fixture for one epoch
    (batch 4, 512x512, f32, `off`: 16 exact forward + 16 backward launches
    a step) with `--val_intervals 1` (the val loss gates model_best, as in
    JAX); the loss finite and falling on a fixed batch; one more step with
    the launch counts zeroed just before and read just after; step p50,
    images/s and peak memory; the loader's host ms a batch; test.py on
    model_best (f32, `off`) writes coco_eval.json through the dataset's
    meta (CocoMeta, CocoHpMeta: 39-column rows scored as boxes);
    `train_vs_cpu` of one step; multi_pose also `main` with `--aug_rot 1
    --rotate 30`, a step of it finite and its loader's host ms a batch.
    Returns (the counts of one step, {loader: ms a batch})."""
    import torch
    from centerpoly_tpu_torch import main as tmain
    from centerpoly_tpu_torch import test as ttest
    from centerpoly_tpu_torch.kernels import dcn

    common = ["--batch_size", str(TRAIN_BATCH), "--num_workers", "0",
              "--num_epochs", "1", "--dcn_kernel", "off"]
    zero_counts()
    tr = tmain.main(task_argv(task, root, "--exp_id", task, "--val_intervals",
                              "1", *common), device="cuda")
    torch.cuda.synchronize()
    counts = {k: v for k, v in dcn.launches.items() if v}
    steps, n_val = tr.state.step, len(tr.val_loader)
    print(f"[{task}-train] main {task} --dcn_kernel off: {steps} steps of "
          f"batch {TRAIN_BATCH} at {tr.cfg.input_h}x{tr.cfg.input_w} + "
          f"{n_val} val batches; launches {counts}; best (-val loss) "
          f"{tr.best:.4f}")
    check((tr.cfg.input_h, tr.cfg.input_w) == CTDET_INPUTS["coco"]
          and steps == 2 and n_val == 1
          and counts == {"exact": 16 * (steps + n_val),
                         "bwd_exact": 16 * steps},
          "expected 16 forward + 16 backward launches a step")
    save_dir = os.path.join(root, "exp", TASK_DATASETS[task], task, task)
    best = os.path.join(save_dir, "model_best.pth")
    check(np.isfinite(tr.best) and os.path.isfile(best),
          f"no model_best.pth after main {task}")
    loss_falls(tr, f"{task} off")
    step = step_launches(tr, 16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    step_times(tr, f"{task} off")
    host = {"plain": loader_ms(tr.train_loader)}
    del tr
    torch.cuda.empty_cache()
    if task == "multi_pose":
        tr = tmain.main(task_argv(task, root, "--exp_id", "rot",
                                  "--val_intervals", "0", "--aug_rot", "1",
                                  "--rotate", "30", *common), device="cuda")
        batch = tr.put(next(iter(tr.train_loader)))
        tr.state, stats = tr.train_step(tr.state, batch)
        loss = float(stats["loss"])
        check(np.isfinite(loss) and float(batch["reg_mask"].sum()) == 0,
              f"rotated multi_pose step: loss {loss}")
        host["rotated"] = loader_ms(tr.train_loader)
        print(f"[{task}-train] --aug_rot 1 --rotate 30: a step's loss "
              f"{loss:.4f} (targets blanked by the rotation)")
        del tr
    print(f"[{task}-train] loader host time a batch of {TRAIN_BATCH} "
          f"(num_workers 0): " + ", ".join(f"{k} {v:.1f} ms"
                                           for k, v in host.items()))
    out = ttest.main(task_argv(task, root, "--exp_id", task, "--load_model",
                               best, "--dcn_kernel", "off",
                               "--no_mixed_precision"), device="cuda")
    check(out["frames"] == CTDET_SPLITS["val"] and out["ap"] is not None
          and os.path.isfile(os.path.join(save_dir, "coco_eval.json"))
          and all(np.isfinite(list(out["ap"].values()))),
          f"test.py {task}: {out['ap']}")
    print(f"[{task}-train] test.py on model_best (f32, off): AP "
          f"{out['ap']['AP']} AP50 {out['ap']['AP50']} (random weights)")
    train_vs_cpu(root, "dla_34", "off", "exact", task=task)
    return step, host


def phase_task(task, root):
    """Phase 21 (exdet) or 22 (multi_pose): see the module doc.  Returns
    the fields of the kernels line."""
    from centerpoly_tpu_torch.data.fixture import (write_box_fixture,
                                                   write_keypoint_fixture)
    t0 = time.perf_counter()
    root = os.path.join(root, task)
    if task == "exdet":
        write_box_fixture(root, CTDET_SPLITS, SEED, *CTDET_FRAME_HW,
                          categories=CTDET_IDS)
    else:
        write_keypoint_fixture(root, CTDET_SPLITS, SEED, *CTDET_FRAME_HW)
    run, dec = phase_task_infer(task, root)
    step, host = phase_task_train(task, root)
    print(f"[{task}] phase {TASK_PHASES[task]} in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"run": run, "step": step, "decode": dec, "host": host}


# ---- phase 23: the ddd task -----------------------------------------------

DDD_FRAME_HW = (375, 1242)      # a KITTI frame
DDD_SPLITS = {"train": 8, "val": 4}
DDD_GT_FRAMES = 40              # 41+ objects a class: AP can reach 100
DDD_TOP = 32                    # rows a frame held card vs CPU


def ddd_frames(root):
    """The KITTI fixture's val frames (375x1242 uint8, PNG) and ids."""
    from centerpoly_tpu_torch.data import CocoPolyAnnotations, KittiMeta
    from centerpoly_tpu_torch.utils.png import read_image
    meta = KittiMeta(root)
    ann = CocoPolyAnnotations(meta.annot_path("val"))
    ids = ann.get_img_ids()
    return ids, [read_image(os.path.join(meta.img_dir("val"),
                                         ann.load_img(i)["file_name"]))
                 for i in ids]


def ddd_rows_agree(a, b, what, score_tol=1e-3, px_tol=1.0, rel_tol=1e-2):
    """Two runs' ddd results ({img_id: {class: (n, 13) rows [alpha, bbox
    4, dim 3, location 3, rotation_y, score]}}): the same frames and
    classes, and each of a frame's `DDD_TOP` best rows of `a` found in
    `b` in its class, its score within `score_tol`, its box within
    `px_tol` px and every other column within `rel_tol` relative (+
    `rel_tol`: the depth 1 / sigmoid - 1 and the lifting amplify the
    heads' differences).  Returns the largest score, box and other
    differences of the matched rows."""
    check(a.keys() == b.keys(), f"{what[0]} and {what[1]}: other frames")
    worst = [0.0, 0.0, 0.0]
    for img_id, per in a.items():
        other = b[img_id]
        check(per.keys() == other.keys(), f"frame {img_id}: other classes")
        rows = [(r[-1], cls, np.asarray(r, np.float64))
                for cls, v in per.items() for r in np.asarray(v).reshape(
                    -1, 13)]
        for score, cls, row in sorted(rows, key=lambda t: -t[0])[:DDD_TOP]:
            cand = np.asarray(other[cls], np.float64).reshape(-1, 13)
            d_s = np.abs(cand[:, -1] - score)
            d_b = np.abs(cand[:, 1:5] - row[1:5]).max(1)
            rest = np.r_[0, 5:12]
            d_r = (np.abs(cand[:, rest] - row[rest])
                   / (1 + np.abs(row[rest]))).max(1)
            ok = (d_s <= score_tol) & (d_b <= px_tol) & (d_r <= rel_tol)
            check(ok.any(), f"frame {img_id}: a class {cls} row of score "
                  f"{score:.4f} has no counterpart in {what[1]}")
            j = np.flatnonzero(ok)[np.argmin(d_b[ok])]
            worst = [max(worst[0], float(d_s[j])), max(worst[1], float(
                d_b[j])), max(worst[2], float(d_r[j]))]
    return worst


def ddd_decode_times(det, frames):
    """`ddd_decode` alone (pseudo-NMS, two-stage top-K at K, the gathers)
    on the sigmoid maps of a bf16 forward, on the card: device ms by CUDA
    events over 20 calls (after 3) at batch 1 and at run_batch's batch."""
    import torch
    from centerpoly_tpu_torch.losses.ddd import ddd_depth_transform
    from centerpoly_tpu_torch.ops.decode import ddd_decode
    trans, meta = det._scaled_trans(*frames[0].shape[:2], 1.0)
    with torch.no_grad():
        x = det._pre_device(torch.from_numpy(np.stack(frames)).cuda(), trans,
                            (meta["inp_h"], meta["inp_w"]))
        heads = det._heads(x)
    out = {k: v.float().permute(0, 2, 3, 1) for k, v in heads.items()}
    res = {}
    for b in (1, len(frames)):
        args = (torch.sigmoid(out["hm"][:b]), out["rot"][:b],
                ddd_depth_transform(out["dep"][:b]), out["dim"][:b])
        kw = {"wh": out["wh"][:b], "reg": out["reg"][:b], "k": det.cfg.K}
        with torch.no_grad():
            res[b] = cuda_ms(lambda: ddd_decode(*args, **kw), 3, 20)
        print(f"[ddd] ddd_decode alone at batch {b} (K {det.cfg.K}, "
              f"{out['hm'].shape[1]}x{out['hm'].shape[2]} maps): "
              f"{res[b]:.3f} ms device time")
    return res


def phase_ddd_infer(root):
    """Phase 23 (a), (b): `create_detector(serving_config(task="ddd",
    dataset="kitti"))` at full width (DLA-34, KITTI's 3 classes, head_conv
    256, 384x1280 input, heads hm 3 / dep 1 / rot 8 / dim 3 / wh 2 / reg
    2, K 128, bf16, rowband:6), seeded random weights, on the fixture's
    375x1242 val frames: `run` with the launch counts zeroed just before
    and read just after (16 `dcn_fwd[rowband]` a frame), one `run` under
    flip_test (a batch of 1, the plain run's results: flip_tta off, still
    16), `run_batch` of 4 (16), `run_stream` equal to `run` frame by frame
    (cuDNN deterministic), run p50 and frames/s (`e2e_times`) and
    `ddd_decode`'s own device time; then in f32 (TF32 off) the heads on
    the card within 2e-3 of the port on the CPU and two frames' best
    rows card vs CPU (`ddd_rows_agree`).  Returns (launches a frame,
    decode ms by batch, the weights)."""
    import torch
    from centerpoly_tpu_torch.infer.detector import create_detector
    from centerpoly_tpu_torch.kernels import dcn
    from centerpoly_tpu_torch.models import create_model

    cfg = serving_config(task="ddd", dataset="kitti")
    check((cfg.input_h, cfg.input_w, cfg.head_conv, cfg.num_classes)
          == (*CTDET_INPUTS["kitti"], 256, 3)
          and cfg.heads == {"hm": 3, "dep": 1, "rot": 8, "dim": 3, "wh": 2,
                            "reg": 2}, "ddd config")
    sd = random_state_dict(create_model(cfg.arch, cfg.heads, cfg.head_conv),
                           SEED + 23)
    ids, frames = ddd_frames(root)
    det = create_detector(cfg, sd)
    check(det.device.type == "cuda" and det.dtype == torch.bfloat16,
          f"detector on {det.device} in {det.dtype}")
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    for i, frame in zip(ids, frames):
        ret, n = run_counted(lambda: det.run(frame), "rowband")
        runs[i] = ret["results"]
        for rows in ret["results"].values():
            check(len(rows) == 0 or (rows.shape[1] == 13
                                     and np.isfinite(rows).all()
                                     and (rows[:, -1] > cfg.peak_thresh).all()),
                  f"ddd frame {i}: rows {rows.shape}")
    counts = [sum(map(len, r.values())) for r in runs.values()]
    check(sum(counts) > 0, "ddd: no rows above peak_thresh")
    det_f = create_detector(serving_config(task="ddd", dataset="kitti",
                                           flip_test=True), sd)
    batches = []
    hook = det_f.model.register_forward_pre_hook(
        lambda mod, args: batches.append(args[0].shape[0]))
    ret_f, n_f = run_counted(lambda: det_f.run(frames[0]), "rowband")
    hook.remove()
    check(batches == [1] and same_results(ret_f["results"], runs[ids[0]]),
          f"ddd under flip_test: batches {batches}, or other results")
    del det_f
    batch, nb = run_counted(lambda: det.run_batch(frames), "rowband")
    check(len(batch) == len(frames), "run_batch returned the wrong count")
    zero_counts()
    streamed = list(det.run_stream(iter(frames), depth=2))
    counts_s = {k: v for k, v in dcn.launches.items() if v}
    torch.backends.cudnn.deterministic = flags
    check(counts_s == {"rowband": 16 * len(frames)},
          f"run_stream launches {counts_s}")
    for i, got in zip(ids, streamed):
        check(same_results(got, runs[i]), f"ddd run_stream frame {i} "
              f"differs from run()")
    print(f"[ddd] bf16 rowband:6 on {len(frames)} {DDD_FRAME_HW[1]}x"
          f"{DDD_FRAME_HW[0]} frames: run {n} dcn_fwd launches a frame, "
          f"under flip_test {n_f} on a batch of {batches[0]} (the plain "
          f"results), run_batch of {len(frames)} {nb}, run_stream equal to "
          f"run; rows a frame above peak_thresh {counts}")
    e2e_times(det, "ddd rowband:6", frames)
    dec = ddd_decode_times(det, frames)
    del det

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = serving_config(task="ddd", dataset="kitti", mixed_precision=False)
    det32 = create_detector(cfg32, sd)
    det_cpu = create_detector(cfg32, sd, device="cpu")
    trans, meta = det_cpu._scaled_trans(*DDD_FRAME_HW, 1.0)
    with torch.no_grad():
        x = det_cpu._pre_device(torch.from_numpy(frames[0])[None], trans,
                                (meta["inp_h"], meta["inp_w"]))
        ref = det_cpu._heads(x)
        got = det32._heads(x.to("cuda", memory_format=torch.channels_last))
    check_heads("ddd 384x1280", ref, got)
    card = {i: det32.run(f)["results"] for i, f in zip(ids[:2], frames)}
    cpu = {i: det_cpu.run(f)["results"] for i, f in zip(ids[:2], frames)}
    worst = ddd_rows_agree(card, cpu, ("the card", "the CPU"))
    print(f"[ddd] f32 card vs CPU: the best {DDD_TOP} rows of 2 frames "
          f"within score {worst[0]:.2e}, box {worst[1]:.2e} px, other "
          f"columns {worst[2]:.2e} relative")
    del det32, det_cpu
    return n, dec, sd


def ddd_gt_results(root):
    """The KITTI label files of a fixture's val frames as result rows of
    the three evaluated classes, at score 1."""
    from centerpoly_tpu_torch.data import CocoPolyAnnotations, KittiMeta
    from centerpoly_tpu_torch.data.fixture import KITTI_CATEGORIES
    names = {v: k for k, v in KITTI_CATEGORIES.items()}
    meta = KittiMeta(root)
    gt_dir = os.path.join(root, "kitti", "training", "label_2")
    out = {}
    for img_id in CocoPolyAnnotations(meta.annot_path("val")).get_img_ids():
        per = {1: [], 2: [], 3: []}
        with open(os.path.join(gt_dir, f"{img_id:06d}.txt")) as f:
            for line in f:
                p = line.split()
                if names[p[0]] in per:
                    per[names[p[0]]].append([float(v) for v in p[3:15]]
                                            + [1.0])
        out[img_id] = {c: np.asarray(v, np.float32).reshape(-1, 13)
                       for c, v in per.items()}
    return out


def phase_ddd_train(root, sd):
    """Phase 23 (c), (d): `main ddd` on the fixture for one epoch (batch
    4, 384x1280, f32, `off`: 16 exact forward + 16 backward launches a
    step) with `--val_intervals 1` (the val loss gates model_best, as in
    JAX); the loss falling on a fixed batch; one more step with the
    launch counts zeroed just before and read just after; step p50,
    images/s and peak memory; the loader's host ms a batch with aug_ddd 0
    and 1; test.py on (a)'s random weights `sd` saved as a reference
    checkpoint (f32, `off`) on the card and on the CPU: KittiMeta's files
    and the native `kitti_eval` built on this machine,
    the two runs' best rows agreeing (`ddd_rows_agree`) and their AP
    dicts equal; then the GT of a 40-frame fixture written as results
    scores AP 100 in detection, BEV and 3D.  Returns (the counts of one
    step, {aug_ddd: loader ms a batch})."""
    import torch
    from centerpoly_tpu_torch import main as tmain
    from centerpoly_tpu_torch import test as ttest
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.data import (CocoPolyAnnotations, DddSampler,
                                           KittiMeta, Loader)
    from centerpoly_tpu_torch.data.fixture import write_kitti3d_fixture
    from centerpoly_tpu_torch.kernels import dcn

    def argv(*extra):
        return ["ddd", "--dataset", "kitti", "--data_dir", root,
                "--save_dir", os.path.join(root, "exp"), "--exp_id", "ddd",
                *extra]

    zero_counts()
    tr = tmain.main(argv("--val_intervals", "1", "--batch_size",
                         str(TRAIN_BATCH), "--num_workers", "0",
                         "--num_epochs", "1", "--dcn_kernel", "off"),
                    device="cuda")
    torch.cuda.synchronize()
    counts = {k: v for k, v in dcn.launches.items() if v}
    steps, n_val = tr.state.step, len(tr.val_loader)
    print(f"[ddd-train] main ddd --dcn_kernel off: {steps} steps of batch "
          f"{TRAIN_BATCH} at {tr.cfg.input_h}x{tr.cfg.input_w} + {n_val} val "
          f"batches; launches {counts}; best (-val loss) {tr.best:.4f}")
    check((tr.cfg.input_h, tr.cfg.input_w) == CTDET_INPUTS["kitti"]
          and steps == 2 and n_val == 1
          and counts == {"exact": 16 * (steps + n_val),
                         "bwd_exact": 16 * steps},
          "expected 16 forward + 16 backward launches a step")
    save_dir = os.path.join(root, "exp", "kitti", "ddd", "ddd")
    best = os.path.join(save_dir, "model_best.pth")
    check(np.isfinite(tr.best) and os.path.isfile(best),
          "no model_best.pth after main ddd")
    loss_falls(tr, "ddd off")
    step = step_launches(tr, 16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    step_times(tr, "ddd off")
    del tr
    torch.cuda.empty_cache()
    meta = KittiMeta(root)
    ann = CocoPolyAnnotations(meta.annot_path("train"))
    host = {}
    for aug in (0.0, 1.0):
        cfg = Config(task="ddd", dataset="kitti", aug_ddd=aug)
        sampler = DddSampler(cfg, meta, ann, img_dir=meta.img_dir("train"))
        host[aug] = loader_ms(Loader(sampler, len(sampler), TRAIN_BATCH))
    print(f"[ddd-train] loader host time a batch of {TRAIN_BATCH} "
          f"(num_workers 0): " + ", ".join(f"aug_ddd {k:g} {v:.1f} ms"
                                           for k, v in host.items()))

    # test.py on (a)'s random weights as a reference checkpoint: two steps
    # from the seeded init leave every score near the heat map's initial
    # 0.1 (no row above peak_thresh), and a map that flat orders its top
    # K by the last digits, which the card and the CPU do not share
    weights = os.path.join(root, "random_weights.pth")
    torch.save({"epoch": 0, "state_dict": sd}, weights)
    torch.backends.cudnn.allow_tf32 = False     # f32 against the CPU
    common = argv("--load_model", weights, "--dcn_kernel", "off",
                  "--no_mixed_precision")
    out = ttest.main(common, device="cuda")
    cpu = ttest.main(common, device="cpu")
    n_rows = [sum(map(len, r.values())) for r in out["results"].values()]
    check(out["frames"] == DDD_SPLITS["val"] and min(n_rows) > 0
          and out["ap"] and os.path.isdir(os.path.join(save_dir, "results")),
          f"test.py ddd: rows {n_rows}, AP {out['ap']}")
    worst = ddd_rows_agree(out["results"], cpu["results"],
                           ("test.py on the card", "test.py on the CPU"))
    check(cpu["ap"] is not None and set(out["ap"]) == set(cpu["ap"]),
          f"test.py's KITTI AP on the card {out['ap']} and on the CPU "
          f"{cpu['ap']}")
    print(f"[ddd-train] test.py on (a)'s weights (f32, off; rows a frame "
          f"{n_rows}): kitti_eval {json.dumps(out['ap'])}; on the CPU "
          f"{'the same' if out['ap'] == cpu['ap'] else json.dumps(cpu['ap'])}"
          f"; the best {DDD_TOP} rows a frame within score {worst[0]:.2e}, "
          f"box {worst[1]:.2e} px, other columns {worst[2]:.2e} relative")

    gt_root = os.path.join(root, "gt")
    write_kitti3d_fixture(gt_root, {"val": DDD_GT_FRAMES}, SEED + 1,
                          max_objects=6)
    gt = ddd_gt_results(gt_root)
    n_obj = {c: sum(len(r[c]) for r in gt.values()) for c in (1, 2, 3)}
    ap = KittiMeta(gt_root).run_eval(gt, os.path.join(gt_root, "out"))
    check(ap is not None and set(ap) == {"car", "pedestrian", "cyclist"}
          and all(per[m] == [100.0] * 3 for per in ap.values()
                  for m in ("detection", "bev", "3d")),
          f"GT as results: {ap}")
    print(f"[ddd-train] {DDD_GT_FRAMES} frames' GT as results ({n_obj} "
          f"objects by class): AP 100 in detection, BEV and 3D, every "
          f"class and difficulty")
    return step, host


def phase_ddd(root):
    """Phase 23: see the module doc.  Returns the fields of the kernels
    line."""
    from centerpoly_tpu_torch.data.fixture import write_kitti3d_fixture
    t0 = time.perf_counter()
    root = os.path.join(root, "ddd")
    write_kitti3d_fixture(root, DDD_SPLITS, SEED)
    run, dec, sd = phase_ddd_infer(root)
    step, host = phase_ddd_train(root, sd)
    print(f"[ddd] phase 23 in {time.perf_counter() - t0:.1f} s")
    return {"run": run, "step": step, "decode": dec, "host": host}


# ---- phase 24: the on-device NMS and the semantic evaluator ------------------

NMS_K = 128


def greedy_nms(boxes, scores, t):
    """Hard NMS, one box at a time in stable score order: the reference
    `hard_nms_batch` is held to."""
    order = np.argsort(-scores, kind="stable")
    keep = np.zeros(len(scores), bool)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        kept = np.flatnonzero(keep)
        x1 = np.maximum(boxes[i, 0], boxes[kept, 0])
        y1 = np.maximum(boxes[i, 1], boxes[kept, 1])
        x2 = np.minimum(boxes[i, 2], boxes[kept, 2])
        y2 = np.minimum(boxes[i, 3], boxes[kept, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        iou = inter / np.maximum(area[i] + area[kept] - inter, 1e-9)
        keep[i] = not (iou > t).any()
    return keep


def phase_nms_semantic():
    """Phase 24: `soft_nms_batch` and `hard_nms_batch` on the card at K
    128 (seeded boxes, a tenth of the scores tied): the decayed scores
    against the host `soft_nms` (as a set, rtol 1e-4, JAX's test's bound)
    and against the port on the CPU (1e-6), the keep mask against a greedy
    reference and the CPU (equal), each one's device ms (CUDA events, 10
    calls after 2); then `evaluate_semantic` on this machine over two
    seeded 1024x2048 label and instance maps, the native cpp/ loop (built
    here) against its numpy path: every score equal, and each path's
    host ms."""
    import torch
    from centerpoly_tpu_torch.eval import native
    from centerpoly_tpu_torch.eval.semantic_eval import (SEMANTIC_LABELS,
                                                         evaluate_semantic)
    from centerpoly_tpu_torch.ops.nms import (hard_nms_batch, soft_nms,
                                              soft_nms_batch)
    rng = np.random.RandomState(SEED + 24)
    xy = rng.rand(NMS_K, 2) * 400
    wh = rng.rand(NMS_K, 2) * 80 + 10
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.rand(NMS_K).astype(np.float32)
    scores[::10] = scores[0]
    bc, sc = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
    soft = soft_nms_batch(bc, sc, thresh=0.0)
    check(soft.device.type == "cuda", "soft_nms_batch left the card")
    host = np.concatenate([boxes, scores[:, None]], 1)
    soft_nms(host, method=2, thresh=0.0)
    soft_cpu = soft_nms_batch(torch.from_numpy(boxes),
                              torch.from_numpy(scores), thresh=0.0).numpy()
    d_host = float(np.abs(np.sort(soft.cpu().numpy())
                          - np.sort(host[:, 4])).max())
    d_cpu = float(np.abs(soft.cpu().numpy() - soft_cpu).max())
    check(np.allclose(np.sort(soft.cpu().numpy()), np.sort(host[:, 4]),
                      rtol=1e-4) and d_cpu <= 1e-6,
          f"soft_nms_batch: {d_host} from the host soft_nms, {d_cpu} from "
          f"the CPU")
    times = {}
    for t in (0.5, 0.7):
        keep = hard_nms_batch(bc, sc, t).cpu().numpy()
        check(np.array_equal(keep, greedy_nms(boxes, scores, t))
              and np.array_equal(keep, hard_nms_batch(
                  torch.from_numpy(boxes), torch.from_numpy(scores),
                  t).numpy()),
              f"hard_nms_batch at {t}: other boxes kept")
    with torch.no_grad():
        times["soft_nms_batch"] = cuda_ms(lambda: soft_nms_batch(bc, sc), 2,
                                          10)
        times["hard_nms_batch"] = cuda_ms(lambda: hard_nms_batch(bc, sc), 2,
                                          10)
    print(f"[nms] K {NMS_K} on the card: soft_nms_batch within "
          f"{d_host:.2e} of the host soft_nms and {d_cpu:.2e} of the CPU, "
          f"{times['soft_nms_batch']:.3f} ms device time; hard_nms_batch "
          f"(0.5, 0.7) equal to the greedy reference and the CPU, "
          f"{times['hard_nms_batch']:.3f} ms (K sequential steps each)")

    check(native._load() is not None,
          f"the native library did not build: {native.last_build_error}")
    inst_ids = [l.id for l in SEMANTIC_LABELS
                if l.has_instances and not l.ignore_in_eval]
    pairs, inst_pairs = [], []
    for _ in range(2):
        blocks = rng.randint(0, 34, (64, 128))
        gt = np.kron(blocks, np.ones((16, 16), np.int64)).astype(np.uint8)
        inst = gt.astype(np.int32)
        for k in range(20):
            cls = inst_ids[rng.randint(len(inst_ids))]
            y0, x0 = rng.randint(0, 900), rng.randint(0, 1800)
            y1, x1 = y0 + rng.randint(20, 120), x0 + rng.randint(20, 240)
            gt[y0:y1, x0:x1] = cls
            inst[y0:y1, x0:x1] = cls * 1000 + k
        plain = ~np.isin(gt, inst_ids)
        inst[plain] = gt[plain]
        pred = gt.copy()
        flip = rng.rand(*gt.shape) < 0.3
        pred[flip] = rng.randint(0, 34, int(flip.sum()))
        pairs.append((pred, gt))
        inst_pairs.append((pred, inst))
    res, ms = {}, {}
    load = native._load
    for path in (True, False):
        if not path:        # the library unavailable: numpy's bincount
            native._load = lambda build_dir=None: None
        try:
            t0 = time.perf_counter()
            res[path] = evaluate_semantic(pairs, inst_pairs)
            ms[path] = 1e3 * (time.perf_counter() - t0)
        finally:
            native._load = load
    a, b = res[True], res[False]
    check(np.array_equal(a["confMatrix"], b["confMatrix"])
          and all(np.allclose(list(a[k].values()), list(b[k].values()),
                              rtol=0, atol=0, equal_nan=True)
                  for k in a if isinstance(a[k], dict))
          and all(a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k]))
                  for k in a if k.startswith("average")),
          "evaluate_semantic: the native path differs from numpy")
    print(f"[semantic] evaluate_semantic on 2 seeded 1024x2048 maps: the "
          f"native loop equal to numpy; mean IoU "
          f"{a['averageScoreClasses']:.4f}, iIoU "
          f"{a['averageScoreInstClasses']:.4f}; host {ms[True]:.1f} ms "
          f"(native) / {ms[False]:.1f} ms (numpy)")
    return times

# ---- phase 25: the remaining modules -----------------------------------------

# the experimental losses' device half at a training batch's width: B 4, K
# 128 object slots of which 32 valid, the 128x256 output map, 16 vertices
EXP_SHAPE = {"B": 4, "K": 128, "valid": 32, "H": 128, "W": 256, "N": 16}
EXP_REPS = ("cartesian", "polar", "polar_fixed")


def exp_inputs(rep, rng):
    """Seeded inputs of both device losses in `rep`: disk rows (B, K,
    2N+1) with their GT rows, polygon rows (B, K, 2N) with their centres
    and a GT mask of filled rectangles, and the object mask."""
    from centerpoly_tpu_torch.geometry import pil_fill
    b, k, n = EXP_SHAPE["B"], EXP_SHAPE["K"], EXP_SHAPE["N"]
    h, w = EXP_SHAPE["H"], EXP_SHAPE["W"]

    def rows(kind):
        if kind == "cartesian":
            return rng.uniform(-20, 20, (b, k, 2 * n))
        r = np.zeros((b, k, 2 * n))
        r[..., 0::2] = rng.uniform(4, 24, (b, k, n))
        r[..., 1::2] = np.sort(rng.uniform(0, 2 * np.pi, (b, k, n)), -1)
        return r

    radius = rng.uniform(-6, 6, (b, k, 1))
    disk_pred = np.concatenate([rows("cartesian"), radius], -1)
    disk_gt = np.concatenate([rows(rep), radius], -1)
    poly = rows(rep)
    centers = rng.uniform([24, 24], [w - 24, h - 24], (b, k, 2))
    target = np.zeros((b, h, w), np.uint8)
    for i in range(b):
        for _ in range(EXP_SHAPE["valid"]):
            x0, y0 = rng.uniform([0, 0], [w - 30, h - 30])
            pil_fill.polygon(target[i], [(x0, y0), (x0 + 30, y0),
                                         (x0 + 30, y0 + 20), (x0, y0 + 20)],
                             fill=1)
    mask = np.zeros((b, k), np.float32)
    mask[:, :EXP_SHAPE["valid"]] = 1
    f32 = np.float32
    return {"disk_pred": disk_pred.astype(f32), "disk_gt": disk_gt.astype(f32),
            "poly": poly.astype(f32), "centers": centers.astype(f32),
            "target": target.astype(f32), "mask": mask}


def exp_loss(name, rep, t, pred):
    """`name` on the device of `t` (exp_inputs' arrays as tensors)."""
    from centerpoly_tpu_torch.losses import experimental as ex
    if name == "disk_loss_device":
        return ex.disk_loss_device(pred, t["mask"], t["disk_gt"],
                                   EXP_SHAPE["H"], EXP_SHAPE["W"], rep)
    return ex.area_poly_loss_device(pred, t["mask"], t["target"],
                                    t["centers"], rep)


def phase_exp_losses(card):
    """Phase 25 (a): `disk_loss_device` and `area_poly_loss_device` in each
    rep at EXP_SHAPE.  In f32 on the card: forward + backward ms (CUDA
    events, 3 calls after 1) and peak memory.  In f64 on the card against
    the port on the CPU: the loss within 1e-4 relative, the gradient of
    pred within 1e-4 of its largest.  The check is in f64 because the
    loss is a min over edges: where two edges lie at nearly the same
    distance from a pixel, an f32 rounding (the card's and the CPU's
    sqrt and sigmoid round differently) sends that pixel's gradient to
    other vertices, a jump of ~1e-3 of the largest gradient (measured
    against f64 on the CPU at B 1, K 32)."""
    import torch
    rng = np.random.RandomState(SEED + 25)
    out = {}
    for rep in EXP_REPS:
        x = exp_inputs(rep, rng)
        t_card = {k: torch.from_numpy(v).cuda() for k, v in x.items()}
        for name, key in (("disk_loss_device", "disk_pred"),
                          ("area_poly_loss_device", "poly")):
            p = t_card[key].clone().requires_grad_(True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            exp_loss(name, rep, t_card, p).backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30

            def step():
                p.grad = None
                exp_loss(name, rep, t_card, p).backward()
            ms = cuda_ms(step, 1, 3)
            del p
            res = {}
            for dev in ("cuda", "cpu"):
                t = {k: torch.from_numpy(v).double().to(dev)
                     for k, v in x.items()}
                q = t[key].clone().requires_grad_(True)
                t0 = time.perf_counter()
                loss = exp_loss(name, rep, t, q)
                loss.backward()
                res[dev] = (float(loss.detach()), q.grad.cpu().numpy(),
                            time.perf_counter() - t0)
                del t, q, loss
            (lv, g, _), (lcv, gc, cpu_s) = res["cuda"], res["cpu"]
            d_loss = abs(lv - lcv) / max(abs(lcv), 1e-12)
            d_grad = float(np.abs(g - gc).max() / max(np.abs(gc).max(),
                                                      1e-300))
            print(f"[exp-loss] {name} {rep} at B {EXP_SHAPE['B']} K "
                  f"{EXP_SHAPE['K']} ({EXP_SHAPE['valid']} valid) "
                  f"{EXP_SHAPE['H']}x{EXP_SHAPE['W']} N {EXP_SHAPE['N']}: "
                  f"f32 forward + backward {ms:.3f} ms, peak {peak:.2f} GiB "
                  f"({card}); f64 loss {lv:.9f} (CPU {lcv:.9f}, relative "
                  f"{d_loss:.2e}), gradient within {d_grad:.2e} of its "
                  f"largest (CPU {cpu_s:.1f} s)")
            check(np.isfinite(lv) and d_loss <= 1e-4 and d_grad <= 1e-4
                  and np.abs(gc).max() > 0,
                  f"{name} {rep}: card vs CPU loss {d_loss:.2e}, gradient "
                  f"{d_grad:.2e}")
            out[f"{name}[{rep}]"] = {"ms": ms, "peak_gib": peak}
        del t_card
    return out


def aux_sampler(root, split, **kw):
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.data import (CityscapesMeta,
                                           CocoPolyAnnotations,
                                           PolydetSampler)
    cfg = Config(task="polydet", dataset="cityscapes", arch="dla_34",
                 input_h=512, input_w=1024, rep="polar", **kw)
    meta = CityscapesMeta(root)
    return PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path(split)), split=split, img_dir=meta.img_dir(split))


def inst_beside(eroot, split):
    """(frame's instance-id path beside it, its gtFine path) for each
    frame of the eval fixture's `split`."""
    from centerpoly_tpu_torch.data import CityscapesMeta
    meta = CityscapesMeta(eroot)
    with open(meta.annot_path(split)) as f:
        names = [im["file_name"] for im in json.load(f)["images"]]
    out = []
    for name in names:
        inst = name.replace("leftImg8bit", "gtFine_instanceIds")
        out.append((os.path.join(meta.img_dir(split), inst),
                    os.path.join(eroot, "gtFine", split, inst)))
    return out


def phase_aux_targets(root, eroot, card):
    """Phase 25 (b): the sampler at the training width (512x1024, polar)
    over phase 9's .npy fixture, default / --cat_spec_poly / --dense_poly,
    host ms a batch of 4 (num_workers 0); over phase 13's Cityscapes-named
    PNG frames with no instance-id PNG beside them, then with the 16-bit
    gtFine PNG beside each (as written, filter None; then re-encoded with
    Paeth, as real gtFine files may be): the extra host ms of reading fg;
    then one DLA-34 `off` train step on such a batch (border_hm and fg
    aboard) with its launches counted: 16 + 16."""
    import shutil
    import torch
    from centerpoly_tpu_torch import main as tmain
    from centerpoly_tpu_torch.data import Loader
    from centerpoly_tpu_torch.utils.png import encode_png, read_png

    host = {}
    for flag, kw in (("default", {}), ("cat_spec_poly",
                                       {"cat_spec_poly": True}),
                     ("dense_poly", {"dense_poly": True})):
        sampler = aux_sampler(root, "train", **kw)
        sample = sampler(0)
        want = {"border_hm", "fg"} | ({"cat_spec_poly", "cat_spec_mask"}
                                      if flag == "cat_spec_poly" else set())
        if flag == "dense_poly":
            want |= {"dense_poly", "dense_poly_mask"}
        check(want <= set(sample) and ("poly" in sample)
              == (flag != "dense_poly") and sample["border_hm"].any()
              and not sample["fg"].any(), f"sampler keys under {flag}")
        host[flag] = loader_ms(Loader(sampler, len(sampler), TRAIN_BATCH,
                                      shuffle=False))
    print(f"[aux-targets] sampler at 512x1024 on the "
          f"{FRAME_HW[1]}x{FRAME_HW[0]} .npy fixture, host ms a batch of "
          f"{TRAIN_BATCH}: " + ", ".join(
              f"{k} {v:.1f}" for k, v in host.items()))
    pairs = inst_beside(eroot, "train")
    fg_ms = {}
    for kind in ("absent", "none", "paeth"):
        for beside, gt in pairs:
            if kind == "none":
                shutil.copy(gt, beside)
            elif kind == "paeth":
                with open(beside, "wb") as f:
                    f.write(encode_png(read_png(gt), filter=4))
        sampler = aux_sampler(eroot, "train")
        check(sampler(0)["fg"].any() == (kind != "absent"),
              f"fg with the instance-id PNG {kind}")
        fg_ms[kind] = loader_ms(Loader(sampler, len(sampler), TRAIN_BATCH,
                                       shuffle=False))
    decode = {}
    for kind, filt in (("none", 0), ("paeth", 4)):
        buf = encode_png(read_png(pairs[0][1]), filter=filt)
        path = os.path.join(eroot, f"inst_{kind}.png")
        with open(path, "wb") as f:
            f.write(buf)
        t0 = time.perf_counter()
        read_png(path)
        decode[kind] = 1e3 * (time.perf_counter() - t0)
    print(f"[aux-targets] fg from a 16-bit {FRAME_HW[1]}x{FRAME_HW[0]} "
          f"gtFine_instanceIds PNG beside each of {len(pairs)} PNG frames: "
          f"host ms a batch of "
          f"{TRAIN_BATCH} {fg_ms['absent']:.1f} (absent) / "
          f"{fg_ms['none']:.1f} (filter None) / {fg_ms['paeth']:.1f} "
          f"(Paeth): +{(fg_ms['none'] - fg_ms['absent']) / TRAIN_BATCH:.1f} "
          f"/ +{(fg_ms['paeth'] - fg_ms['absent']) / TRAIN_BATCH:.1f} ms a "
          f"frame; one decode {decode['none']:.1f} / {decode['paeth']:.1f} "
          f"ms")
    tr = tmain.main(train_argv(eroot, "off", val_intervals=0)
                    + ["--exp_id", "aux_targets"], device="cuda")
    batch = next(iter(tr.train_loader))
    check(float(batch["fg"].sum()) > 0 and batch["border_hm"].any(),
          "the train batch carries no fg / border_hm")
    step = step_launches(tr, 16)
    print(f"[aux-targets] one DLA-34 off train step (batch {TRAIN_BATCH}, "
          f"512x1024, f32) on a batch with border_hm and fg: launches "
          f"{step} ({card})")
    del tr
    torch.cuda.empty_cache()
    return {"step": step, "host": host, "fg_ms": fg_ms, "decode": decode}


def phase_host_tools(eroot, card):
    """Phase 25 (c): the host tools on this machine's CPU: polygon GT
    jsons made from phase 13's 16-bit val GT PNGs (one outer contour an
    instance, tools/contours.py), then
    `gt_polygons.main` (regular_interval, 16 points) over them,
    `csv_to_coco` on its CSV, `coco_poly_to_polar`, `polygon_coverage`,
    `simplify_masks` over one 8-bit mask an instance, and
    `visualize_results` on test.py's eval_batch 1 results; host seconds
    of each."""
    import glob
    from centerpoly_tpu_torch import tools
    from centerpoly_tpu_torch.tools import contours, gt_polygons
    from centerpoly_tpu_torch.utils.png import read_png, write_png

    secs = {}
    t0 = time.perf_counter()
    mask_dir = os.path.join(eroot, "inst_masks")
    os.makedirs(mask_dir, exist_ok=True)
    n_inst = 0
    for _, gt in inst_beside(eroot, "val"):
        ids = read_png(gt)
        objects = []
        for v in np.unique(ids[ids >= 1000]):
            m = (ids == v).astype(np.uint8) * 255
            cnt = max(contours.find_external_contours(m), key=len)
            objects.append({"label": "car",
                            "polygon": cnt.reshape(-1, 2).tolist()})
            write_png(os.path.join(mask_dir, f"{os.path.basename(gt)[:-4]}"
                                   f"_{int(v)}.png"), m)
            n_inst += 1
        with open(gt.replace("_instanceIds.png", "_polygons.json"), "w") as f:
            json.dump({"imgHeight": int(ids.shape[0]),
                       "imgWidth": int(ids.shape[1]), "objects": objects}, f)
    secs["polygon jsons"] = time.perf_counter() - t0
    csv_path = os.path.join(eroot, "gt_val.csv")
    t0 = time.perf_counter()
    gt_polygons.main(["--data_dir", eroot, "--split", "val", "--out",
                      csv_path])
    secs["generate_annotations"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    coco = tools.csv_to_coco(csv_path, os.path.join(eroot, "gt_val.json"))
    secs["csv_to_coco"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tools.coco_poly_to_polar(os.path.join(eroot, "gt_val.json"),
                             os.path.join(eroot, "gt_val_polar.json"))
    secs["coco_poly_to_polar"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cover = tools.polygon_coverage(os.path.join(eroot, "gt_val.json"))
    secs["polygon_coverage"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tools.simplify_masks(mask_dir, os.path.join(eroot, "inst_simple"))
    secs["simplify_masks"] = time.perf_counter() - t0
    ious = []
    for name in sorted(os.listdir(mask_dir)):
        a = read_png(os.path.join(mask_dir, name)) > 0
        b = read_png(os.path.join(eroot, "inst_simple", name)) > 0
        ious.append((a & b).sum() / max((a | b).sum(), 1))
    results = glob.glob(os.path.join(eroot, "exp", "cityscapes", "polydet",
                                     "test_b1", "results.json"))
    check(len(results) == 1, "phase 13's test.py results.json is missing")
    from centerpoly_tpu_torch.data import CocoPolyAnnotations, CityscapesMeta
    meta = CityscapesMeta(eroot)
    ann = CocoPolyAnnotations(meta.annot_path("val"))
    t0 = time.perf_counter()
    written = tools.visualize_results(
        results[0], meta.img_dir("val"), os.path.join(eroot, "vis"),
        id_to_file={i: ann.load_img(i)["file_name"]
                    for i in ann.get_img_ids()})
    secs["visualize_results"] = time.perf_counter() - t0
    print(f"[host-tools] {n_inst} GT instances of {EVAL_FRAMES} "
          f"{FRAME_HW[1]}x{FRAME_HW[0]} val frames -> "
          f"{len(coco['annotations'])} 16-point annotations, "
          f"coverage mean IoU {cover['mean_iou']:.4f} over {cover['n']}, "
          f"simplified masks' IoU with theirs >= {min(ious):.4f}, "
          f"{len(written)} overlays; host s: " + ", ".join(
              f"{k} {v:.3f}" for k, v in secs.items()))
    check(len(coco["annotations"]) == n_inst > 0 and cover["n"] == n_inst
          and cover["mean_iou"] > 0.5 and min(ious) > 0.9
          and len(written) > 0, "the host tools on the eval fixture")
    return secs


NO_HOST_LIBS = ("PIL", "cv2", "matplotlib")


def phase_remaining(root, card):
    """Phase 25: see the module doc; PIL, cv2 and matplotlib unimportable
    throughout (some card machines have the first two).  Returns the
    fields of the kernels line."""
    t0 = time.perf_counter()
    eroot = os.path.join(root, "eval")
    saved = {m: sys.modules.get(m) for m in NO_HOST_LIBS}
    sys.modules.update(dict.fromkeys(NO_HOST_LIBS))
    try:
        losses = phase_exp_losses(card)
        aux = phase_aux_targets(root, eroot, card)
        tools_s = phase_host_tools(eroot, card)
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    print(f"[remaining] phase 25 in {time.perf_counter() - t0:.1f} s, "
          f"{', '.join(NO_HOST_LIBS)} unimportable")
    return {"losses": losses, "aux": aux, "tools": tools_s}


def stop_helper_processes():
    """Stop multiprocessing's forkserver (test.py's matcher pool starts
    it) and resource tracker, which would otherwise outlive the script
    for a moment."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def main() -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bwd-times", action="store_true",
                    help="run only phases 1, 2 and the backward's per-node "
                    "times of phase 10, without its check against the plain "
                    "version, and print no result line: to compare a tree "
                    "with a variant of it in one card call")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from centerpoly_tpu_torch.data.fixture import write_rect_fixture

    name, count, card = phase_card()
    phase_build()
    if args.bwd_times:
        phase_bwd_times(check_plain=False)
        return 0
    errs = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        det, sd, frames, launches = phase_slice()
        det_halo, launches["halo"] = phase_halo_slice(sd, frames, root)
        per_frame, bound_frame, by = phase_times(det, det_halo, frames)
        f32_step, f32_bound, f32_by = phase_fwd_train_times()
        phase_profile(det, det_halo, frames)
        del det, det_halo
        bwd_errs = phase_bwd_vs_plain()
        write_rect_fixture(root, 2 * TRAIN_BATCH, SEED, *FRAME_HW,
                           splits=("train", "val"))
        trainers, bwd_launches = phase_train(root)
        phase_train_vs_cpu(root)
        per_step, bound_step, bwd_by, bwd_f32_bound, errs10 = (
            phase_bwd_times())
        phase_train_times(trainers)
        phase_loader_workers(root)
        del trainers
        phase_hourglass_infer(frames)
        phase_hourglass_train(root)
        resdcn_node = phase_resdcn_node_times()
        resdcn18 = phase_resdcn18(frames, root)
        resdcn101 = phase_resdcn101(frames, root)
        phase_eval(root, card)
        dp = phase_data_parallel(root, card)
        weights = phase_demo(sd, root, card)
        csv_launches = phase_run_on_csv(sd, weights, root, card)
        conv = phase_convergence(root, card)
        ctdet = phase_ctdet(root)
        tasks = {t: phase_task(t, root) for t in TASK_PHASES}
        ddd = phase_ddd(root)
        phase_nms_semantic()
        remaining = phase_remaining(root, card)
    kernels = [{"name": f"dcn_fwd[{mode}]", "route": "cuda",
                "source": SOURCES["dcn_fwd"],
                "replaces": REPLACES[f"dcn_fwd[{mode}]"],
                "launches": launches[mode], "max_abs_err": errs[mode],
                "ms": per_frame[mode]["ms"],
                "plain_ms": per_frame[mode]["plain_ms"],
                "bound_ms": bound_frame, "bound_by": by, "library_ms": None,
                "f32_step_ms": f32_step[mode]["ms"],
                "f32_step_plain_ms": f32_step[mode]["plain_ms"],
                "f32_step_bound_ms": f32_bound, "f32_step_bound_by": f32_by}
               for mode in FWD_CLAMPS]
    # phase 14: launches a rank a data-parallel step, and of a run_batch
    # over two replicas
    kernels[0]["dp_rank_step_launches"] = dp["dp"]["exact"]
    kernels[1]["sharded_run_batch_launches"] = dp["sharded"]
    # phases 15 and 16: resdcn launches a frame and a train step, each
    # counted in its own run; resdcn_101's 2048-channel node (bf16 batch 1,
    # f32 batch 4)
    kernels[0]["resdcn18_train_step_launches"] = resdcn18["step"]["exact"]
    kernels[0]["resdcn101_train_step_launches"] = resdcn101["exact"]
    kernels[1]["resdcn18_run_launches"] = resdcn18["run"]
    # phases 18 and 19: rowband launches a frame of run_on_csv; of the
    # dla_34 convergence run, the launches a train step (its training
    # launches over its steps), of the whole run, of the rowband re-score,
    # and the largest errors at its node shapes
    kernels[1]["run_on_csv_launches"] = csv_launches
    kernels[0].update(conv_fields(conv, "exact"))
    kernels[1]["convergence_rescore_launches"] = conv["rescore"]
    kernels[1]["convergence_nodes_f32_max_abs_err"] = conv["errs"]["rowband"]
    # phase 20: ctdet's launches a frame (rowband:6) and a train step
    # (exact), its node shapes, its kernels' largest errors there and the
    # forward's time over a 512x512 frame's 16 nodes (bf16, batch 1)
    kernels[1]["ctdet_run_launches"] = ctdet["run"]
    kernels[0]["ctdet_train_step_launches"] = ctdet["step"]["exact"]
    for k, mode in zip(kernels, FWD_CLAMPS):
        k.update({"ctdet_node_shapes": ctdet["shapes"],
                  "ctdet_nodes_max_abs_err": ctdet["fwd_err"][mode]})
        for key, t in ctdet["times"].items():
            pre = "ctdet_{}x{}_frame_".format(*CTDET_INPUTS[key])
            k.update({pre + "ms": t["frame"][mode]["ms"],
                      pre + "plain_ms": t["frame"][mode]["plain_ms"],
                      pre + "bound_ms": t["bound_ms"],
                      pre + "bound_by": t["bound_by"]})
    # phases 21 and 22: exdet's and multi_pose's launches a frame
    # (rowband:6) and a train step (exact)
    for t, res in tasks.items():
        kernels[1][f"{t}_run_launches"] = res["run"]
        kernels[0][f"{t}_train_step_launches"] = res["step"]["exact"]
    # phase 23: ddd's launches a 1242x375 frame (rowband:6) and a train
    # step at 384x1280 (exact)
    kernels[1]["ddd_run_launches"] = ddd["run"]
    kernels[0]["ddd_train_step_launches"] = ddd["step"]["exact"]
    for k, mode in zip(kernels, FWD_CLAMPS):
        node, node32 = resdcn_node["fwd"][mode], resdcn_node["fwd_f32"][mode]
        k.update({f"resdcn101_node_{key}": node[key] for key in node})
        k.update({f"resdcn101_node_f32_step_{key}": node32[key]
                  for key in node32})
    kernels += [{"name": f"dcn_bwd[{mode}]", "route": "cuda",
                 "source": SOURCES["dcn_bwd"],
                 "replaces": REPLACES[f"dcn_bwd[{mode}]"],
                 "launches": bwd_launches[mode],
                 "max_abs_err": max(bwd_errs[mode], errs10[mode]),
                 "ms": per_step[mode]["ms"],
                 "plain_ms": per_step[mode]["plain_ms"],
                 "bound_ms": bound_step, "bound_by": bwd_by,
                 "library_ms": None,
                 "eager_ms": per_step[mode]["eager_ms"],
                 "f32_core_bound_ms": bwd_f32_bound}
                for mode in BWD_CLAMPS]
    kernels[3]["dp_rank_step_launches"] = dp["dp"]["bwd_exact"]
    kernels[3]["resdcn18_train_step_launches"] = resdcn18["step"]["bwd_exact"]
    kernels[3]["resdcn101_train_step_launches"] = resdcn101["bwd_exact"]
    kernels[3].update(conv_fields(conv, "bwd_exact"))
    kernels[3]["ctdet_train_step_launches"] = ctdet["step"]["bwd_exact"]
    for t, res in tasks.items():
        kernels[3][f"{t}_train_step_launches"] = res["step"]["bwd_exact"]
    kernels[3]["ddd_train_step_launches"] = ddd["step"]["bwd_exact"]
    # phase 25: a DLA-34 train step on a batch carrying border_hm and fg
    kernels[0]["aux_targets_train_step_launches"] = (
        remaining["aux"]["step"]["exact"])
    kernels[3]["aux_targets_train_step_launches"] = (
        remaining["aux"]["step"]["bwd_exact"])
    for k, mode in zip(kernels[3:], BWD_CLAMPS):
        k.update({"ctdet_node_shapes": ctdet["shapes"],
                  "ctdet_nodes_max_abs_err": ctdet["bwd_err"][mode]})
    for k, mode in zip(kernels[3:], BWD_CLAMPS):
        node = resdcn_node["bwd"][mode]
        k.update({f"resdcn101_node_{key}": node[key] for key in node})
    stop_helper_processes()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
