"""Inference detector API.

Behavioral reference: src/lib/detectors/base_detector.py:18-191,
detectors/polydet.py:21-101 and detectors/ctdet.py:24-101, as the JAX
package serves them: `run(image)` returns {'results': {class_id: (n, D)
arrays}, 'tot'/'load'/'pre'/'net'/'dec'/'post'/'merge': seconds}; polydet
rows are [x0, y0, x1, y1, score, poly..., depth], ctdet rows [x0, y0, x1,
y1, score], in source-image coordinates.  The ddd, exdet and multi_pose
detectors (infer/task_detectors.py) share this run loop.

On the device: the axis-aligned affine warp + normalisation of the full
frame, the model, sigmoid, optional flip average and the top-K decode.
On the host: the inverse affine back to source coordinates and the merge.
`run_batch(images)` runs one forward over a stack of frames, or, with a
list of devices, one replica of the net per device (the JAX package's
`mesh`); `run_stream(frames)` pipelines a stream of them (several in
flight).  With `cfg.debug > 0`, `run` also composes the debug views
(utils/debugger.py) from its own forward.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..configs import Config
from ..geometry.affine import get_affine_transform, warp_axis_aligned
from ..models import create_model
from ..ops.decode import ctdet_decode, polydet_decode
from ..ops.nms import soft_nms
from ..utils.timers import StageTimer, span
from ..weights import load_reference_checkpoint, load_weights, \
    state_dict_from_jax


def polydet_post_process(dets: np.ndarray, c, s, out_h: int, out_w: int,
                         num_classes: int) -> List[Dict[int, list]]:
    """Map decoded detections (B, K, 6+2N+1) back to source-image coords,
    split per class (ref post_process.py:105-122, vectorized)."""
    ret = []
    for i in range(dets.shape[0]):
        trans = get_affine_transform(c[i], s[i], 0, (out_w, out_h), inv=True)
        d = dets[i].copy()
        pts = d[:, :4].reshape(-1, 2)
        d[:, :4] = (pts @ trans[:, :2].T + trans[:, 2]).reshape(-1, 4)
        poly = d[:, 6:-1].reshape(-1, 2)
        d[:, 6:-1] = (poly @ trans[:, :2].T + trans[:, 2]).reshape(
            d.shape[0], -1)
        classes = d[:, 5]
        top: Dict[int, list] = {}
        for j in range(num_classes):
            inds = classes == j
            top[j + 1] = np.concatenate(
                [d[inds, :4], d[inds, 4:5], d[inds, 6:]], axis=1
            ).astype(np.float32).tolist()
        ret.append(top)
    return ret


def ctdet_post_process(dets: np.ndarray, c, s, out_h: int, out_w: int,
                       num_classes: int) -> List[Dict[int, list]]:
    """Map decoded ctdet detections (B, K, 6) back to source-image coords,
    split per class into [x0, y0, x1, y1, score] rows (ref
    post_process.py:86-104)."""
    ret = []
    for i in range(dets.shape[0]):
        trans = get_affine_transform(c[i], s[i], 0, (out_w, out_h), inv=True)
        d = dets[i].copy()
        pts = d[:, :4].reshape(-1, 2)
        d[:, :4] = (pts @ trans[:, :2].T + trans[:, 2]).reshape(-1, 4)
        classes = d[:, 5]
        top: Dict[int, list] = {}
        for j in range(num_classes):
            inds = classes == j
            top[j + 1] = d[inds, :5].astype(np.float32).tolist()
        ret.append(top)
    return ret


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class Replica:
    """One copy of the net for `run_batch`: its device, model,
    normalisation constants and CUDA stream (None on the CPU, and for the
    detector's own model without a device list: it runs on the current
    stream)."""
    device: torch.device
    model: torch.nn.Module
    mean: torch.Tensor
    std: torch.Tensor
    stream: object = None


class BaseDetector:
    """Shared run loop: pre-process -> device program -> post -> merge,
    with the reference's 7-stage timing (base_detector.py:105-191)."""

    def __init__(self, cfg: Config, variables=None, rng_seed: int = 0,
                 device=None, devices: Sequence | None = None):
        """`variables`: a state_dict of this package, or the JAX package's
        {"params", "batch_stats"} tree; else cfg.load_model (a reference
        .pth); else random weights from `rng_seed`.  `devices`: run_batch
        shards its frames over one replica of the net on each entry (an
        entry may repeat: two replicas on one card), each on its own
        stream.  `run` and `run_stream` use the detector's own net (on
        the first entry by default), which is also the first replica when
        it lives on the first entry."""
        self.cfg = cfg
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            device = devices[0] if device is None else device
        self.device = resolve_device(device)
        # bf16 only on the card; the CPU path is the f32 reference
        self.dtype = (torch.bfloat16 if cfg.mixed_precision
                      and self.device.type == "cuda" else torch.float32)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            model = create_model(cfg.arch, cfg.heads, cfg.head_conv,
                                 dcn_kernel=cfg.dcn_kernel)
        if variables is None and cfg.load_model:
            report = load_weights(model, load_reference_checkpoint(
                cfg.load_model))
            print(f"loaded {cfg.load_model}: {len(report['loaded'])} loaded, "
                  f"{len(report['skipped'])} skipped, "
                  f"{len(report['missing'])} missing")
        elif variables is not None:
            if "params" in variables:
                variables = state_dict_from_jax(variables, cfg.arch)
            load_weights(model, variables, strict=True)
        self.model = model.to(self.device, self.dtype,
                              memory_format=torch.channels_last).eval()
        self.mean = torch.tensor(cfg.mean, dtype=torch.float32,
                                 device=self.device)
        self.std = torch.tensor(cfg.std, dtype=torch.float32,
                                device=self.device)
        self.num_classes = cfg.num_classes
        self.max_per_image = cfg.K
        self.scales = cfg.test_scales
        own = Replica(self.device, self.model, self.mean, self.std)
        self.replicas = [own] if devices is None else [
            self._replica(d, own, share=i == 0 and d == self.device)
            for i, d in enumerate(devices)]

    @staticmethod
    def _replica(device: torch.device, own: Replica,
                 share: bool = False) -> Replica:
        """The detector's own net (`share`: the first entry, on its
        device) or a copy of it and its constants on `device`, with a
        stream of its own on a card."""
        rep = (dataclasses.replace(own) if share else
               Replica(device, copy.deepcopy(own.model).to(device),
                       own.mean.to(device), own.std.to(device)))
        if device.type == "cuda":
            rep.stream = torch.cuda.Stream(device)
            # the copies ran on the default stream: done before any
            # replica's stream reads them
            torch.cuda.synchronize(device)
        return rep

    # -- device programs -------------------------------------------------

    # a task whose _decode merges the [originals; flipped] halves under
    # flip_test keeps this True; exdet sets it False: its reference
    # post-process reads only the unflipped rows, so the flipped half
    # would double the device time for the same results
    flip_tta: bool = True

    def _pre_device(self, frames_u8: torch.Tensor, trans, size,
                    replica: Replica | None = None) -> torch.Tensor:
        """uint8 (B, H, W, 3) frames -> normalized (B[*2], 3, inp_h, inp_w)
        network input in the model's dtype and memory format, with the
        constants of `replica` (the detector's own by default); doubled as
        [originals; flipped] under flip_test where `flip_tta` is set."""
        rep = replica or self.replicas[0]
        x = torch.stack([warp_axis_aligned(f.float(), trans, size)
                         for f in frames_u8])
        x = ((x / 255.0 - rep.mean) / rep.std).permute(0, 3, 1, 2)
        if self.cfg.flip_test and self.flip_tta:
            x = torch.cat([x, x.flip(3)])
        return x.to(self.dtype, memory_format=torch.channels_last)

    def _heads(self, images, model=None):
        return (model or self.model)(images)[-1]

    def _decode(self, heads):
        """The head maps of one forward (NCHW) -> decoded detections."""
        raise NotImplementedError

    def _process_device(self, images, model=None):
        return self._decode(self._heads(images, model))

    # -- host orchestration ---------------------------------------------

    def pre_process_meta(self, height: int, width: int, scale: float):
        """The affine + meta of ref base_detector:41-88."""
        cfg = self.cfg
        new_h, new_w = int(height * scale), int(width * scale)
        if cfg.fix_res:
            inp_h, inp_w = cfg.input_h, cfg.input_w
            c = np.array([new_w / 2.0, new_h / 2.0], dtype=np.float32)
            s = max(height, width) * 1.0
        else:
            inp_h = (new_h | cfg.pad) + 1
            inp_w = (new_w | cfg.pad) + 1
            c = np.array([new_w // 2, new_h // 2], dtype=np.float32)
            s = np.array([inp_w, inp_h], dtype=np.float32)
        trans = get_affine_transform(c, s, 0, (inp_w, inp_h))
        meta = {"c": c, "s": s,
                "inp_h": inp_h, "inp_w": inp_w,
                "out_height": inp_h // cfg.down_ratio,
                "out_width": inp_w // cfg.down_ratio}
        return trans, meta

    def _scaled_trans(self, h: int, w: int, scale: float):
        """pre_process_meta's transform is defined on SCALED-image coords
        (the reference resizes by `scale` first, base_detector.py:41-60);
        folding the scale into the matrix makes one warp of the original
        frame geometrically identical to its resize + warp."""
        trans, meta = self.pre_process_meta(h, w, scale)
        if scale != 1.0:
            trans = trans.copy()
            trans[:, :2] *= scale
        return trans, meta

    def _post(self, dets_host: np.ndarray, meta, scale: float):
        raise NotImplementedError

    @torch.no_grad()
    def run(self, image: np.ndarray) -> Dict:
        """Full pipeline on one HWC uint8 image.  Returns results + the
        reference's 7-stage timing dict: `pre` and `net` are the card's
        time between events at their boundaries (StageTimer), the others
        the host's; `tot` is the call's wall time."""
        timer = StageTimer(self.device)
        with span("run"):
            with timer.stage("load"):
                image = np.asarray(image)
                frame = torch.from_numpy(image).to(self.device)[None]
            detections = []
            for scale in self.scales:
                with timer.stage("pre", device=True):
                    trans, meta = self._scaled_trans(*image.shape[:2], scale)
                    images = self._pre_device(frame, trans,
                                              (meta["inp_h"], meta["inp_w"]))
                with timer.stage("net", device=True):
                    heads = self._heads(images)
                    dets = self._decode(heads)
                with timer.stage("dec"):
                    dets_host = dets.cpu().numpy()
                with timer.stage("post"):
                    detections.append(self._post(dets_host, meta, scale))
            with timer.stage("merge"):
                results = self.merge_outputs(detections)
            if self.cfg.debug > 0:
                self._debug_views(image, images, heads, results)
        times = timer.read()
        return {"results": results,
                **{k: times.get(k, 0.0) for k in
                   ("tot", "load", "pre", "net", "dec", "post", "merge")}}

    def _upload(self, array: np.ndarray, device=None) -> torch.Tensor:
        """Host array -> `device` (the detector's by default) without
        waiting: on the card through pinned memory with non_blocking=True
        (a pageable copy would wait for the frames already in flight)."""
        device = device or self.device
        t = torch.from_numpy(np.ascontiguousarray(array))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    @staticmethod
    def _fetch(dets: torch.Tensor):
        """(detections on the host, CUDA event or None): on the card they
        are copied to pinned host memory behind an event on the current
        stream and are valid once it has completed."""
        if dets.device.type != "cuda":
            return dets.cpu(), None
        host = torch.empty(dets.shape, dtype=dets.dtype, pin_memory=True)
        host.copy_(dets, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _dispatch(self, frame: torch.Tensor, scale: float):
        """Pre-process, forward and decode one (1, H, W, 3) uint8 frame on
        the device at one scale, without waiting for it.  Returns
        (detections on the host, CUDA event or None, meta): on the card the
        detections are copied to pinned host memory behind an event and
        are valid once it has completed."""
        trans, meta = self._scaled_trans(*frame.shape[1:3], scale)
        images = self._pre_device(frame, self._upload(trans.astype(np.float32)),
                                  (meta["inp_h"], meta["inp_w"]))
        return (*self._fetch(self._process_device(images)), meta)

    @torch.no_grad()
    def run_stream(self, frames, depth: int = 2):
        """Pipelined single-stream serving: a generator that keeps up to
        `depth` frames in flight on the device while the host
        post-processes earlier ones, yielding each frame's merged results
        ({class_id: (n, D) array}, what `run(frame)["results"]` holds) in
        order.

        Frames go up through pinned memory and detections come back into
        pinned memory behind a CUDA event, so dispatching frame i+1
        overlaps the device's work on frame i and the host's
        post-processing of frame i-1; a frame is waited for only on its
        own event (the JAX package's run_stream, infer/detector.py:240-271,
        where jax dispatch is asynchronous).  Debug views are not rendered
        in stream mode.  Each stage's span carries the frame's sequence
        number, as frames overlap."""
        inflight: collections.deque = collections.deque()

        def finish(seq, entry):
            detections = []
            for host, done, meta, scale in entry:
                if done is not None:
                    with span("stream.wait", seq):
                        done.synchronize()      # the only blocking point
                with span("stream.post", seq):
                    detections.append(self._post(host.numpy(), meta, scale))
            with span("stream.merge", seq):
                return self.merge_outputs(detections)

        for seq, image in enumerate(frames):
            if len(inflight) >= max(1, depth):
                yield finish(*inflight.popleft())
            with span("stream.upload", seq):
                frame = self._upload(np.asarray(image))[None]
            with span("stream.dispatch", seq):
                inflight.append((seq, [(*self._dispatch(frame, s), s)
                                       for s in self.scales]))
        while inflight:
            yield finish(*inflight.popleft())

    @torch.no_grad()
    def run_batch(self, images) -> list:
        """Batched pipeline: one forward per scale over the whole stack of
        same-shaped frames (flip TTA as [originals(B); flipped(B)]).
        Returns a list of {"results": ...} dicts (no stage timers).

        With several replicas (`devices`) the stack is padded to a
        multiple of their count with copies of the last frame (the JAX
        package's run_batch over a mesh) and split in order; each slice
        runs on its replica's device and stream, all launched from this
        thread before any is waited for, and only the real frames'
        results come back.

        Its stages are spans inside `serve.batch` that tile the call
        (per replica and scale where they repeat): `serve.upload`,
        `serve.pre`, `serve.net`, `serve.decode`, `serve.fetch`,
        `serve.wait`, `serve.post`, `serve.merge`."""
        with span("serve.batch"):
            with span("serve.upload"):
                frames = np.stack([np.asarray(im) for im in images])
                h, w = frames.shape[1:3]
                n = len(self.replicas)
                pad = (-len(frames)) % n
                if pad:
                    frames = np.concatenate(
                        [frames, np.repeat(frames[-1:], pad, 0)])
                scaled = [(self._scaled_trans(h, w, s), s)
                          for s in self.scales]
            launched = []
            for rep, chunk in zip(self.replicas, np.split(frames, n)):
                with (torch.cuda.stream(rep.stream) if rep.stream is not None
                      else contextlib.nullcontext()):
                    with span("serve.upload"):
                        x_u8 = self._upload(chunk, rep.device)
                    per_scale = []
                    for (trans, meta), _ in scaled:
                        with span("serve.pre"):
                            x = self._pre_device(
                                x_u8, trans, (meta["inp_h"], meta["inp_w"]),
                                rep)
                        with span("serve.net"):
                            heads = self._heads(x, rep.model)
                        with span("serve.decode"):
                            dets = self._decode(heads)
                        with span("serve.fetch"):
                            per_scale.append(self._fetch(dets))
                    launched.append(per_scale)
            per_frame = []
            for per_scale in launched:
                with span("serve.wait"):
                    for _, done in per_scale:
                        if done is not None:
                            done.synchronize()
                with span("serve.post"):
                    dets = [host.numpy() for host, _ in per_scale]
                    per_frame += [[self._post(d[i:i + 1], meta, scale)
                                   for d, ((_, meta), scale)
                                   in zip(dets, scaled)]
                                  for i in range(len(dets[0]))]
            with span("serve.merge"):
                return [{"results": self.merge_outputs(d)}
                        for d in per_frame[:len(images)]]

    def _debug_views(self, image, images, heads, results):
        """Compose the debug views of the last scale's forward (ref
        base_detector debug flow + detectors/polydet.py:78-100):
        `pred_hm`, the sigmoid of the heat-map head of that same forward
        blended over the network input, and `detections`, the rows above
        vis_thresh drawn on the frame; level 4 saves both to
        cfg.debug_dir.  The composed views stay in `self.debugger`."""
        from ..utils.debugger import Debugger

        cfg = self.cfg
        dbg = Debugger(num_classes=self.num_classes,
                       class_names=None, down_ratio=cfg.down_ratio)
        inp = images[0].float().permute(1, 2, 0).cpu().numpy()
        img = (inp * np.asarray(cfg.std) + np.asarray(cfg.mean)) * 255.0
        img = np.clip(img, 0, 255).astype(np.uint8)
        # exdet's net has no fused "hm" head: its centre heat map is "hm_c"
        # (ref debuggers show hm_t/l/b/r separately)
        hm_key = ("hm" if "hm" in heads
                  else "hm_c" if "hm_c" in heads else None)
        if hm_key is not None:
            hm = torch.sigmoid(heads[hm_key][0].float()).permute(1, 2, 0)
            dbg.add_blend_img(img, dbg.gen_colormap(hm.cpu().numpy()),
                              "pred_hm")
        dbg.add_img(image.astype(np.uint8), img_id="detections")
        # a row's score and box: ddd's rows are [alpha, bbox 4, dim 3,
        # location 3, rotation_y, score]; the others start [bbox 4, score]
        for j, rows in results.items():
            for row in np.asarray(rows):
                score = row[-1] if cfg.task == "ddd" else row[4]
                if score <= cfg.vis_thresh:
                    continue
                if cfg.task == "polydet":
                    dbg.add_polydet(row[5:-1], int(j) - 1, score,
                                    img_id="detections")
                    continue
                box = row[1:5] if cfg.task == "ddd" else row[:4]
                dbg.add_coco_bbox(box, int(j) - 1, score,
                                  img_id="detections")
                if cfg.task == "multi_pose":
                    dbg.add_coco_hp(row[5:39], img_id="detections")
        if cfg.debug >= 4:
            dbg.save_all_imgs(cfg.debug_dir)
        self.debugger = dbg

    def merge_outputs(self, detections):
        """Concat scales + optional soft-NMS + global top-K score cut
        (ref detectors/polydet.py:62-76)."""
        results = {}
        for j in range(1, self.num_classes + 1):
            results[j] = np.concatenate(
                [d[j] for d in detections], axis=0).astype(np.float32)
            if len(self.scales) > 1 or self.cfg.nms:
                soft_nms(results[j], nt=0.5, method=2)
        scores = np.hstack(
            [results[j][:, 4] for j in range(1, self.num_classes + 1)])
        if len(scores) > self.max_per_image:
            kth = len(scores) - self.max_per_image
            thresh = np.partition(scores, kth)[kth]
            for j in range(1, self.num_classes + 1):
                keep = results[j][:, 4] >= thresh
                results[j] = results[j][keep]
        return results


class PolydetDetector(BaseDetector):
    """Polygon instance detector (ref detectors/polydet.py)."""

    def _decode(self, heads):
        cfg = self.cfg
        out = {k: v.float().permute(0, 2, 3, 1)
               for k, v in heads.items()}                       # NHWC views
        hm = torch.sigmoid(out["hm"])
        poly = out["poly"]
        depth = out["pseudo_depth"]
        reg = out["reg"] if cfg.reg_offset else None
        if cfg.flip_test:
            # average original + x-flipped heatmap/depth; polygons are not
            # flip-symmetric per channel, keep the unflipped branch
            nb = hm.shape[0] // 2
            hm = (hm[:nb] + hm[nb:].flip(2)) / 2
            depth = (depth[:nb] + depth[nb:].flip(2)) / 2
            poly = poly[:nb]
            reg = reg[:nb] if reg is not None else None
        return polydet_decode(hm, poly, depth, reg=reg, k=cfg.K, rep=cfg.rep)

    def _post(self, dets_host, meta, scale):
        d0 = polydet_post_process(
            dets_host[:1], [meta["c"]], [meta["s"]],
            meta["out_height"], meta["out_width"], self.num_classes)[0]
        length = 5 + 2 * self.cfg.nbr_points + 1
        for j in range(1, self.num_classes + 1):
            d0[j] = np.array(d0[j], dtype=np.float32).reshape(-1, length)
            d0[j][:, :4] /= scale
            d0[j][:, 5:-1] /= scale
        return d0


class CtdetDetector(BaseDetector):
    """Box detector of the ctdet task (ref detectors/ctdet.py)."""

    def _decode(self, heads):
        cfg = self.cfg
        out = {k: v.float().permute(0, 2, 3, 1)
               for k, v in heads.items()}                       # NHWC views
        hm = torch.sigmoid(out["hm"])
        wh = out["wh"]
        reg = out["reg"] if cfg.reg_offset else None
        if cfg.flip_test:
            # average original + x-flipped heat map and wh; the offsets
            # are not flip-symmetric, keep the unflipped branch
            nb = hm.shape[0] // 2
            hm = (hm[:nb] + hm[nb:].flip(2)) / 2
            wh = (wh[:nb] + wh[nb:].flip(2)) / 2
            reg = reg[:nb] if reg is not None else None
        return ctdet_decode(hm, wh, reg=reg, k=cfg.K,
                            cat_spec_wh=cfg.cat_spec_wh)

    def _post(self, dets_host, meta, scale):
        d0 = ctdet_post_process(
            dets_host[:1], [meta["c"]], [meta["s"]],
            meta["out_height"], meta["out_width"], self.num_classes)[0]
        for j in range(1, self.num_classes + 1):
            d0[j] = np.array(d0[j], dtype=np.float32).reshape(-1, 5)
            d0[j][:, :4] /= scale
        return d0


DETECTORS = {"polydet": PolydetDetector, "ctdet": CtdetDetector}


def create_detector(cfg: Config, variables: Mapping | None = None,
                    device=None, devices: Sequence | None = None
                    ) -> BaseDetector:
    """detector_factory equivalent (ref detectors/detector_factory.py).
    Runs on the card unless `device` names another (e.g. "cpu").
    `devices` (the JAX package's `mesh` argument): run_batch serves the
    frame stack over one replica on each (train/mesh.py::serving_devices
    gives the first n cards)."""
    cls = DETECTORS.get(cfg.task)
    if cls is None:
        raise ValueError(f"unknown task {cfg.task!r}: the detectors are "
                         f"{', '.join(sorted(DETECTORS))}")
    return cls(cfg, variables=variables, device=device, devices=devices)


# the ddd, exdet and multi_pose detectors (infer/task_detectors.py)
# subclass BaseDetector, so they register once it is defined
from .task_detectors import (DddDetector, ExdetDetector,  # noqa: E402
                             MultiPoseDetector)

DETECTORS.update({"exdet": ExdetDetector, "multi_pose": MultiPoseDetector,
                  "ddd": DddDetector})
