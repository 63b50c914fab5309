"""The small hourglass of CenterPoly v2: one stack
(reference/hourglass.py), no DCN node."""
from __future__ import annotations

from ..hourglass import HourglassNet


def build(conf: dict, max_offset_y: int | None = None):
    return HourglassNet(conf["heads"], num_stacks=1,
                        head_conv=conf["head_conv"])
