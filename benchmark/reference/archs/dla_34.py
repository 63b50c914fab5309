"""DLA-34 with its 16 DCNv2 up-sampling nodes (reference/dla.py)."""
from __future__ import annotations

from ..dla import DLASeg


def build(conf: dict, max_offset_y: int | None = None):
    """The nodes y-clamped to `max_offset_y` where given."""
    return DLASeg(conf["heads"], head_conv=conf["head_conv"],
                  max_offset_y=max_offset_y)
