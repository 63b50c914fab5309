"""ResNet-101-DCN of CenterNet, as CenterPoly v2 carries it (`--arch
resdcn_101`), named as the reference's torch modules.

Behavioral reference: src/lib/models/networks/resnet_dcn.py.  The trunk
is He et al. 2016's ResNet: a 7x7 stride-2 stem (`conv1`, `bn1`), a 3x3
stride-2 max pool, then four stages of bottlenecks (1x1 -> 3x3 -> 1x1
at 64 / 128 / 256 / 512 channels, x4 out; the stride on the first
block's 3x3, a 1x1 + BN `downsample` where the width or the stride
changes).  Then three up stages, each [DCNv2 3x3 -> BN -> ReLU -> 4x4
stride-2 ConvTranspose2d -> BN -> ReLU] at 256 / 128 / 64 channels
(resnet_dcn.py:216-243, `deconv_layers.<idx>`), and the heads
(reference/heads.py) at stride 4.  Parameter names are the
reference's (`conv1`, `bn1`, `layerN.i.convK` / `bnK` /
`downsample.{0,1}`, `deconv_layers.<idx>`, `<head>.{0,2}`), so its
state_dict loads as it is.  `max_offset_y`: the y-clamp of every DCNv2
node (None: exact).  NCHW throughout; f32, run with PyTorch's TF32
switches off (harness/tf32.py, around the serving cell's check).

Departures from resnet_dcn.py:
- no initialisation of its own (the ImageNet trunk, `fill_up_weights`'
  bilinear up-sampling kernels, the heads' fills): the benchmark loads
  seeded weights into every entry;
- the DCN nodes are reference/dcn.py's plain DCNv2, not the DCNv2 CUDA
  extension, with the rowband y-clamp where asked;
- BatchNorm in train mode tracks the biased batch variance
  (reference/layers.py); eval mode, which serving runs, is
  nn.BatchNorm2d's.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .dcn import DCNv2
from .heads import head_stack
from .layers import BatchNorm2d

BLOCKS_101 = (3, 4, 23, 3)
PLANES = (64, 128, 256, 512)
UP_WIDTHS = (256, 128, 64)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), each with BatchNorm, and the skip
    (resnet_dcn.py Bottleneck)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                BatchNorm2d(planes * 4))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        skip = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + skip)


class ResNetDCN(nn.Module):
    """The ResNet-101 trunk, the three DCN up stages and the heads.
    `forward` returns a one-element list of NCHW head maps, the
    reference model contract."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 64,
                 max_offset_y: int | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (n, planes) in enumerate(zip(BLOCKS_101, PLANES), 1):
            layer = []
            for i in range(n):
                layer.append(Bottleneck(inplanes, planes,
                                        2 if i == 0 and stage > 1 else 1))
                inplanes = planes * 4
            setattr(self, f"layer{stage}", nn.Sequential(*layer))
        up = []
        for width in UP_WIDTHS:
            up += [DCNv2(inplanes, width, max_offset_y), BatchNorm2d(width),
                   nn.ReLU(inplace=True),
                   nn.ConvTranspose2d(width, width, 4, 2, 1, bias=False),
                   BatchNorm2d(width), nn.ReLU(inplace=True)]
            inplanes = width
        self.deconv_layers = nn.Sequential(*up)
        self.heads = dict(heads)
        for name, module in head_stack(heads, inplanes, head_conv).items():
            self.add_module(name, module)

    def forward(self, x) -> List[Dict[str, torch.Tensor]]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        x = self.deconv_layers(x)
        return [{name: getattr(self, name)(x) for name in self.heads}]
