"""ResNet backbones with deconv upsampling (SimpleBaselines style).

Behavioral reference: src/lib/models/networks/msra_resnet.py (res_18 /
res_101: a ResNet trunk, then three 4x4 stride-2 deconv stages to stride
4) and resnet_dcn.py (resdcn_18 / resdcn_101: each deconv stage preceded
by a DCNv2 3x3 + BN + ReLU); the JAX package's models/resnet.py.  Module
and parameter names are the reference's (`conv1`, `bn1`,
`layerN.i.convK` / `bnK` / `downsample.{0,1}`, `deconv_layers.<idx>`,
`<head>.{0,2}`), so its state_dict loads as it is.  NCHW; each DCNv2
node runs kernels/dcn.py in the `dcn_kernel` mode.

Initialization follows the JAX package's flax defaults, so a seeded init
means the same in both packages: convolution and transposed-convolution
kernels lecun-normal (truncated at 2 sigma), biases 0, BatchNorm scale 1
and bias 0, heatmap head bias -2.19, DCNv2 as models/deform_conv.py
(he-normal weight, zero offset/mask conv).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from .deform_conv import DCNv2
from .heads import head_stack
from .layers import BatchNorm2d

# the deconv stages' widths: msra_resnet.py:126-130 and resnet_dcn.py:149-153
DECONV_WIDTHS = (256, 256, 256)
DCN_DECONV_WIDTHS = (256, 128, 64)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """k x k conv, torch's symmetric padding k // 2, no bias."""
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class BasicBlock(nn.Module):
    """3x3-3x3 residual block (msra_resnet.py BasicBlock)."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        skip = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + skip)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 residual block, stride on the 3x3 (msra_resnet.py
    Bottleneck)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4, stride)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        skip = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + skip)


def _downsample(cin: int, cout: int, stride: int):
    """1x1 conv + BN on the skip path where the block changes width or
    stride, else None."""
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


RESNET_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}


class Deconv(nn.ConvTranspose2d):
    """4x4 stride-2 transposed conv, padding 1, no bias: one upsample
    stage, twice the height and width.  flax's padding="SAME" at k=4,
    s=2 pads the dilated input by (2, 2), which is torch's padding=1; the
    JAX kernel is this weight spatially flipped (weights.py, kind
    `deconv`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, stride=2, padding=1, bias=False)


def _lecun_normal_(w: torch.Tensor, fan_in: int):
    """flax's default kernel init: a normal of variance 1 / fan_in
    truncated at 2 sigma (std rescaled by the truncation's 0.8796)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)


class ResNetDet(nn.Module):
    """ResNet trunk -> 3 deconv stages (with a DCNv2 node before each for
    resdcn) -> heads at stride 4.  `forward` returns a one-element list of
    NCHW head maps, the reference model contract."""

    def __init__(self, heads: Dict[str, int], num_layers: int = 18,
                 head_conv: int = 64, use_dcn: bool = False,
                 dcn_kernel: str = "auto"):
        super().__init__()
        if num_layers not in RESNET_SPECS:
            raise KeyError(f"no ResNet-{num_layers} (have "
                           f"{sorted(RESNET_SPECS)})")
        block, layers = RESNET_SPECS[num_layers]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        # torch MaxPool2d(3, 2, padding=1), as the JAX package pads
        # (resnet.py:91-94): symmetric, not SAME
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (n_blocks, planes) in enumerate(
                zip(layers, (64, 128, 256, 512)), 1):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (i == 0 and stage > 1) else 1
                blocks.append(block(inplanes, planes, stride))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        stages = []
        for width in DCN_DECONV_WIDTHS if use_dcn else DECONV_WIDTHS:
            if use_dcn:
                # resnet_dcn.py:216-243: [DCN, BN, ReLU, up, BN, ReLU]
                stages += [DCNv2(inplanes, width, dcn_kernel),
                           BatchNorm2d(width), nn.ReLU(inplace=True)]
                inplanes = width
            stages += [Deconv(inplanes, width), BatchNorm2d(width),
                       nn.ReLU(inplace=True)]
            inplanes = width
        self.deconv_layers = nn.Sequential(*stages)
        self.heads = dict(heads)
        for name, module in head_stack(heads, inplanes, head_conv).items():
            self.add_module(name, module)
        self._init_like_jax()

    @torch.no_grad()
    def _init_like_jax(self):
        own_init = {id(c) for m in self.modules() if isinstance(m, DCNv2)
                    for c in m.modules()}
        for m in self.modules():
            if id(m) in own_init:
                continue
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, m.weight[0].numel())
            elif isinstance(m, nn.ConvTranspose2d):
                # torch (Cin, Cout, k, k); flax's fan_in is k * k * Cin
                _lecun_normal_(m.weight, m.weight[:, 0].numel())
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
        for name in self.heads:
            if "hm" in name:
                getattr(self, name)[2].bias.fill_(-2.19)

    def forward(self, x) -> List[Dict[str, torch.Tensor]]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        x = self.deconv_layers(x)
        return [{name: getattr(self, name)(x) for name in self.heads}]
