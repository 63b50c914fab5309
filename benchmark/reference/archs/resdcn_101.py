"""ResNet-101-DCN (reference/resnet.py): 3 / 4 / 23 / 3 bottlenecks and
three DCNv2 up stages."""
from __future__ import annotations

from ..resnet import ResNetDCN


def build(conf: dict, max_offset_y: int | None = None):
    """The nodes y-clamped to `max_offset_y` where given."""
    return ResNetDCN(conf["heads"], head_conv=conf["head_conv"],
                     max_offset_y=max_offset_y)
