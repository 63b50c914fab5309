"""Per-stage wall-clock timing (reference: src/lib/detectors/
base_detector.py:105-191), fenced with torch.cuda.synchronize()."""
from __future__ import annotations

import time
from typing import Dict

import torch


class StageTimer:
    """Accumulates named stage durations.  A device stage passes its output
    as `fence`: a CUDA tensor makes the stage wait for the card, since
    PyTorch returns before the kernels finish."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stage(self, name: str, fence: torch.Tensor | None = None):
        if fence is not None and fence.is_cuda:
            torch.cuda.synchronize(fence.device)
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + (now - self._t0)
        self._t0 = now
