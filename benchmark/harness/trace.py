"""The traced sub-window: torch.profiler over the last calls of a run,
kept in memory, reduced to the device's kernel intervals, the host's
operations and the harness's own spans (`bench.*`)."""
from __future__ import annotations

import collections

import torch

# device kernels by kind, from their names (the port's chip_smoke.py
# PROFILE_KINDS): cuDNN / CUTLASS convolutions (implicit GEMM, and the FFT
# engines and layout transforms cuDNN picks for f32 without TF32),
# BatchNorm, copies and uploads, Adam's fused multi-tensor kernels.  A
# plain cuBLAS GEMM is no convolution here (the input warp runs two).
KINDS = {"convolution": ("implicit_gemm", "fprop", "dgrad", "wgrad",
                         "cudnn::cnn", "cutlass", "fft",
                         "pointwise_mult_and_sum_complex", "gemm_cf32",
                         "engines_precompiled"),
         "batchnorm": ("batch_norm", "batchnorm", "Welford"),
         "copy": ("Memcpy", "direct_copy", "Memset"),
         "adam": ("multi_tensor", "Adam", "adam")}


def kind_of(name: str) -> str:
    return next((k for k, words in KINDS.items()
                 if any(w in name for w in words)), "other")


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """Kernel intervals `kernels` [(name, start_us, end_us)] and host
    events `host` [(name, start_us, end_us)] of one profile, on one
    timeline; the window runs from the first `bench.*` span's start (the
    first kernel's, where there is no span) to the last span's or
    kernel's end."""

    def __init__(self, kernels, host):
        self.kernels = kernels
        self.host = host
        spans = [(s, e) for n, s, e in host if n.startswith("bench.")]
        ends = [e for _, e in spans] + [e for _, _, e in kernels]
        starts = [s for s, _ in spans] or [s for _, s, _ in kernels]
        self.start = min(starts) if starts else 0.0
        self.end = max(ends) if ends else self.start
        self.busy = _union([(max(s, self.start), min(e, self.end))
                            for _, s, e in kernels if e > self.start])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def kernel_s(self, words=(), kind=None) -> float:
        """Device seconds of the kernels whose name holds one of `words`
        (or of the kind `kind`)."""
        return sum(e - s for n, s, e in self.kernels
                   if (kind is not None and kind_of(n) == kind)
                   or any(w in n for w in words)) / 1e6

    def device_ops(self, n: int = 10):
        """[[kernel name, seconds]] of the `n` kernels that took longest
        in all, longest first."""
        total = collections.Counter()
        for name, s, e in self.kernels:
            total[name] += (e - s) / 1e6
        return [[k, v] for k, v in total.most_common(n)]

    def idle_gaps(self, n: int = 10):
        """[[host operation, seconds]] of the `n` longest stretches of the
        window with no kernel running, each named by the innermost host
        operation that spans its middle and the host operation that ended
        last before it (the host's Python between operations is not
        traced)."""
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        gaps = [(e - s, s, e) for s, e in zip(edges[0::2], edges[1::2])
                if e > s]
        out = []
        for length, s, e in sorted(gaps, reverse=True)[:n]:
            mid = (s + e) / 2
            around = [(hs, name) for name, hs, he in self.host
                      if hs <= mid <= he]
            before = [(he, name) for name, hs, he in self.host if he <= mid]
            label = max(around)[1] if around else "(no host operation)"
            if before:
                label += " after " + max(before)[1]
            out.append([label, length / 1e6])
        return out


# the profiler's own records among its events (torch's _filter_name)
_BOOKKEEPING = {"[memory]", "[OutOfMemory]",
                "profiler::_record_function_enter",
                "profiler::_record_function_enter_new",
                "profiler::_record_function_exit"}


def profile(fn, with_host: bool = True) -> Trace:
    """Run `fn()` under torch.profiler (host and device, a synchronize at
    the end) and return its Trace.  `with_host=False`: the device's
    activity alone (kernels, copies, sets), which costs the host far less
    than a trace of every operation; the window is then its kernels'."""
    from torch.profiler import ProfilerActivity, profile as _profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] if with_host or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with _profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    # the profiler's raw events, read without torch's parse into a tree
    # of FunctionEvents (a minute for a window's 10^5 kernels)
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    events = [(ev.name(), ev.device_type() == torch.autograd.DeviceType.CPU,
               (ev.start_ns() - t0) / 1e3,
               (ev.start_ns() - t0 + ev.duration_ns()) / 1e3,
               getattr(ev, "is_user_annotation", lambda: False)())
              for ev in res.events() if ev.name() not in _BOOKKEEPING]
    host_names = {name for name, on_host, *_ in events if on_host}
    kernels, host = [], []
    for name, on_host, start, end, annotation in events:
        if on_host:
            host.append((name, start, end))
        elif not (annotation or name in host_names
                  or name.startswith("bench.")):
            # a record_function range (the harness's `bench.*` spans,
            # Adam's Optimizer.step) also shows on the device as a span
            # over the kernels it launched: not an operation of its own
            kernels.append((name, start, end))
    return Trace(kernels, host)
