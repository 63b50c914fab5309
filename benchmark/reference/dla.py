"""DLA-34 backbone with deformable-conv iterative deep aggregation.

Behavioral reference: src/lib/models/networks/pose_dla_dcn.py — DLA trunk
(levels [1,1,1,2,2,1], channels [16,32,64,128,256,512], :310-316), DLAUp /
IDAUp where every projection and merge node is a DCNv2 DeformConv
(:347-413), and a grouped transposed-conv upsample with bilinear init
(:335-344, 372-375).  Module and parameter names are the reference's, so
its state_dict loads as it is.  `max_offset_y`: the y-clamp of every
DCNv2 node (None: exact).  NCHW throughout.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from .dcn import DeformConvBlock
from .heads import head_stack
from .layers import BatchNorm2d, ConvBN, Residual, bilinear_upsample_kernel

LEVELS = (1, 1, 1, 2, 2, 1)
CHANNELS = (16, 32, 64, 128, 256, 512)


class Root(nn.Module):
    """Aggregation node: concat children -> 1x1 conv -> BN (+res) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 residual: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn = BatchNorm2d(out_channels)
        self.residual = residual

    def forward(self, *children):
        x = self.bn(self.conv(torch.cat(children, 1)))
        if self.residual:
            x = x + children[0]
        return torch.relu(x)


class Tree(nn.Module):
    """Recursive DLA tree (ref pose_dla_dcn.py:169-222)."""

    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        if levels == 1:
            self.tree1 = Residual(in_channels, out_channels, stride)
            self.tree2 = Residual(out_channels, out_channels, 1)
            self.root = Root(root_dim, out_channels, root_residual)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual)
        self.levels = levels
        self.level_root = level_root
        self.downsample = nn.MaxPool2d(stride, stride) if stride > 1 else None
        # the reference builds and runs `project` at every level; only a
        # level-1 tree reads its output (a deeper one passes it to a Tree
        # that ignores it), but in training its BatchNorm statistics move
        self.project = (ConvBN(in_channels, out_channels, 1, relu=False)
                        if in_channels != out_channels else None)

    def forward(self, x, children=None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample is not None else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        if self.training and self.project is not None:
            self.project(bottom)     # running statistics only
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """DLA trunk: 6 feature levels at strides 1..32."""

    def __init__(self, levels: Sequence[int] = LEVELS,
                 channels: Sequence[int] = CHANNELS):
        super().__init__()
        self.base_layer = ConvBN(3, channels[0], 7)
        self.level0 = self._conv_level(channels[0], channels[0], levels[0])
        self.level1 = self._conv_level(channels[0], channels[1], levels[1], 2)
        self.level2 = Tree(levels[2], channels[1], channels[2], 2)
        self.level3 = Tree(levels[3], channels[2], channels[3], 2,
                           level_root=True)
        self.level4 = Tree(levels[4], channels[3], channels[4], 2,
                           level_root=True)
        self.level5 = Tree(levels[5], channels[4], channels[5], 2,
                           level_root=True)

    @staticmethod
    def _conv_level(in_channels, out_channels, convs, stride=1):
        """One flat Sequential of conv/bn/relu triples (ref
        _make_conv_level)."""
        layers = []
        for i in range(convs):
            layers += list(ConvBN(in_channels, out_channels,
                                  stride=stride if i == 0 else 1))
            in_channels = out_channels
        return nn.Sequential(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        y = []
        x = self.base_layer(x)
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            y.append(x)
        return y


class DepthwiseUpsample(nn.ConvTranspose2d):
    """Learnable depthwise stride-f transposed conv, bilinear-initialized
    (ref pose_dla_dcn.py:372-375 grouped ConvTranspose2d + fill_up_weights)."""

    def __init__(self, channels: int, factor: int):
        super().__init__(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)
        with torch.no_grad():
            self.weight.copy_(torch.from_numpy(
                bilinear_upsample_kernel(2 * factor)).expand_as(self.weight))


class IDAUp(nn.Module):
    """Iterative deep aggregation step (ref pose_dla_dcn.py:362-387): for
    layers[1:], project to `out_channels` (DCN), upsample, and merge with
    the previous layer through a DCN node."""

    def __init__(self, out_channels: int, channels: Sequence[int],
                 up_factors: Sequence[int], max_offset_y: int | None = None):
        super().__init__()
        self.n = len(channels)
        def block(cin, cout):
            return DeformConvBlock(cin, cout, max_offset_y)
        for i in range(1, self.n):
            setattr(self, f"proj_{i}", block(channels[i], out_channels))
            setattr(self, f"up_{i}", DepthwiseUpsample(
                out_channels, int(up_factors[i])))
            setattr(self, f"node_{i}", block(out_channels, out_channels))

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        out = [layers[0]]
        for i in range(1, self.n):
            x = getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(layers[i]))
            out.append(getattr(self, f"node_{i}")(x + out[i - 1]))
        return out


class DLAUp(nn.Module):
    """Aggregate the deepest levels upward (ref pose_dla_dcn.py:390-413)."""

    def __init__(self, channels: Sequence[int], max_offset_y: int | None = None):
        super().__init__()
        n = len(channels)
        scales = [2 ** i for i in range(n)]
        in_channels = list(channels)
        for i in range(n - 1):
            j = n - i - 2  # aggregate layers[j:] onto layers[j]'s scale
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]], max_offset_y))
            scales[j + 1:] = [scales[j]] * (n - j - 1)
            in_channels[j + 1:] = [channels[j]] * (n - j - 1)
        self.n = n

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        out = [layers[-1]]
        for i in range(self.n - 1):
            j = self.n - i - 2
            layers = layers[:j] + getattr(self, f"ida_{i}")(layers[j:])
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA-34 + DLAUp + final IDAUp + heads at stride `down_ratio`
    (ref pose_dla_dcn.py:427-482).  `forward` returns a one-element list of
    NCHW head maps, the reference model contract."""

    def __init__(self, heads: Dict[str, int], down_ratio: int = 4,
                 last_level: int = 5, head_conv: int = 256,
                 max_offset_y: int | None = None):
        super().__init__()
        self.first_level = int(np.log2(down_ratio))
        self.last_level = last_level
        self.base = DLA()
        channels = CHANNELS[self.first_level:]
        self.dla_up = DLAUp(channels, max_offset_y)
        n = last_level - self.first_level
        self.ida_up = IDAUp(channels[0], channels[:n],
                            [2 ** i for i in range(n)], max_offset_y)
        self.heads = dict(heads)
        for name, module in head_stack(heads, channels[0], head_conv).items():
            self.add_module(name, module)

    def forward(self, x) -> List[Dict[str, torch.Tensor]]:
        layers = self.base(x)[self.first_level:]
        y = self.ida_up(self.dla_up(layers)[:self.last_level - self.first_level])
        return [{name: getattr(self, name)(y[-1]) for name in self.heads}]
