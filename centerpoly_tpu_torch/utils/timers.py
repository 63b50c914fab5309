"""Named spans on the profiler's clock, and `run`'s per-stage times
(reference: src/lib/detectors/base_detector.py:105-191).

`span(name)` marks a stage of the serving or training path.  While a
torch profiler records, it is a `record_function` range `cp.<name>` among
the profile's host events, on the timeline of the kernels it launched;
otherwise it costs one flag check.  Spans nest on the host thread: a
stage's parent is the span around it."""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """Context manager: the range `cp.<name>` (with `args`, as a string)
    while a profiler records, else nothing (a record_function costs ~10
    us even with no profiler)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function(f"cp.{name}",
                           None if args is None else str(args))


class StageTimer:
    """Named stage durations of one call, each stage under the span
    `run.<stage>`.  A host stage is timed on the host's clock; a device
    stage (`device=True`) on a card is the time between CUDA events
    recorded at its boundaries on the current stream, so no stage waits
    for the card: `read` takes them once the caller has waited (the D2H
    copy of the results).  On the CPU every stage is a host stage."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self.times: Dict[str, float] = {}
        self._events = []
        self._t0 = time.perf_counter()

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @contextlib.contextmanager
    def stage(self, name: str, device: bool = False):
        on_card = device and self.device is not None \
            and self.device.type == "cuda"
        with span(f"run.{name}"):
            start = self._event() if on_card else time.perf_counter()
            yield
            if on_card:
                self._events.append((name, start, self._event()))
            else:
                self.times[name] = (self.times.get(name, 0.0)
                                    + time.perf_counter() - start)

    def read(self) -> Dict[str, float]:
        """Seconds by stage, with the device stages' event times, and
        `tot`, the wall time since the timer was made."""
        times = dict(self.times)
        for name, start, end in self._events:
            times[name] = times.get(name, 0.0) + start.elapsed_time(end) / 1e3
        times["tot"] = time.perf_counter() - self._t0
        return times
