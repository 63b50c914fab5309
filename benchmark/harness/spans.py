"""The port's spans in a traced sub-window (`cp.*`: the record_function
ranges of centerpoly_tpu_torch/utils/timers.py::span, among the trace's
host events), against the device's busy intervals.

A span's self time is its duration less the part of it that its `cp.*`
children cover.  A stage is a span with no `cp.*` span inside it (each
of `serve.*` but `serve.batch`, each of `train.*` but `train.step`).  At
each instant of the window the innermost open span is the one whose self
time holds it.  A trace of a program without spans gives nothing to
read: empty results."""
from __future__ import annotations

import collections

PREFIX = "cp."


class _Span:
    __slots__ = ("name", "start", "end", "children")

    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end
        self.children = []

    def self_intervals(self):
        """[(start, end)] of the span that no child covers."""
        out, at = [], self.start
        for s, e in sorted(self.children):
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.end > at:
            out.append((at, self.end))
        return out


def _tree(trace):
    """Every `cp.*` span of the trace's host events, each with its
    children's intervals (clipped to it): spans nest on one host
    thread, so a span's parent is the innermost span open at its start."""
    found = sorted(((n, s, e) for n, s, e in trace.host
                    if n.startswith(PREFIX)), key=lambda x: (x[1], -x[2]))
    out, stack = [], []
    for name, s, e in found:
        while stack and stack[-1].end <= s:
            stack.pop()
        span = _Span(name, s, e)
        if stack:
            parent = stack[-1]
            parent.children.append((s, min(e, parent.end)))
        out.append(span)
        stack.append(span)
    return out


def present(trace, prefix: str = PREFIX) -> bool:
    """Whether the trace holds a span whose name starts with `prefix`."""
    return any(n.startswith(prefix) for n, _, _ in trace.host)


def self_s(trace) -> collections.Counter:
    """{span name: seconds of self time}, summed over its instances."""
    out = collections.Counter()
    for span in _tree(trace):
        out[span.name] += sum(e - s for s, e in span.self_intervals()) / 1e6
    return out


def idle(trace):
    """[(start, end)] of the window in which the device runs nothing."""
    edges = [trace.start] + [x for iv in trace.busy for x in iv] + [trace.end]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def idle_by_stage(trace) -> collections.Counter:
    """{stage name: seconds of device idle time during which it was the
    innermost open span}; under None the idle time during which no stage
    was open (outside every span, or inside a parent between its
    stages)."""
    labelled = sorted((s, e, span.name if not span.children else None)
                      for span in _tree(trace)
                      for s, e in span.self_intervals())
    gaps = idle(trace)
    out = collections.Counter()
    i = j = 0
    while i < len(labelled) and j < len(gaps):
        s, e, name = labelled[i]
        a, b = gaps[j]
        lo, hi = max(s, a), min(e, b)
        if hi > lo:
            out[name] += (hi - lo) / 1e6
        if e < b:
            i += 1
        else:
            j += 1
    out[None] = (sum(e - s for s, e in gaps) / 1e6
                 - sum(v for k, v in out.items() if k is not None))
    return out
