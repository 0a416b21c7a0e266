"""Deep Layer Aggregation backbone (counterpart of
``visualdet3d_tpu/models/backbones/dla.py``), NCHW in channels_last.

Recursive Tree/Root topology, 6 levels out (strides 1, 2, 4, 8, 16, 32),
``dlanet(depth)``. DLA-34 uses levels (1, 1, 1, 2, 2, 1) and channels
(16, 32, 64, 128, 256, 512) with basic blocks. Submodule names mirror the
flax names (``base_layer``, ``level0_conv``, ``tree1``, ``tree2``, ``root``,
``project_conv``, ``Conv_N``, ``BatchNorm_N``), so the weight bridge loads
path for path. Paddings are the JAX package's: explicit symmetric ones for
the 3x3 block convs and ``level1_conv`` (torch parity), 'SAME' (odd kernels,
stride 1) elsewhere; the tree's down-sampling is a 2x2/2 max-pool.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.models.blocks import bn2d, is_calibrating
from visualdet3d_tpu_torch.registry import BACKBONE_DICT

DLA_SPECS = {
    34: ((1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512), 'basic'),
    46: ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), 'bottleneck'),
    60: ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), 'bottleneck'),
    102: ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), 'bottleneck'),
    169: ((1, 1, 2, 3, 5, 1), (16, 32, 128, 256, 512, 1024), 'bottleneck'),
}


class DLABasicBlock(nn.Module):
    """3x3 conv pair with an external residual input."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, stride, padding=dilation,
                                dilation=dilation, bias=False)
        self.BatchNorm_0 = bn2d(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=dilation, dilation=dilation,
                                bias=False)
        self.BatchNorm_1 = bn2d(features)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        return F.relu(out + residual)


class DLABottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (inner width ``features // 2``)."""
    expansion = 2

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        bottle = features // self.expansion
        self.Conv_0 = nn.Conv2d(in_channels, bottle, 1, bias=False)
        self.BatchNorm_0 = bn2d(bottle)
        self.Conv_1 = nn.Conv2d(bottle, bottle, 3, stride, padding=dilation,
                                dilation=dilation, bias=False)
        self.BatchNorm_1 = bn2d(bottle)
        self.Conv_2 = nn.Conv2d(bottle, features, 1, bias=False)
        self.BatchNorm_2 = bn2d(features)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        return F.relu(out + residual)


class Root(nn.Module):
    """Aggregate children: concat, kxk conv ('SAME'), BN, optional residual,
    ReLU."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 residual: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size,
                                padding=(kernel_size - 1) // 2, bias=False)
        self.BatchNorm_0 = bn2d(features)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]):
        x = self.BatchNorm_0(self.Conv_0(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """Recursive aggregation tree.

    ``children_channels``: the channels of the children the parent passes
    in (the flax module learns them from its inputs; a torch module needs
    them to size its root). As in the JAX package (and the reference), a
    tree always projects its own ``bottom`` for the residual; with
    ``levels > 1`` that residual is unused, so the projection's parameters
    exist (the bridge loads them) and it is computed only in train mode,
    without gradient, for the running statistics of its BatchNorm, which
    flax updates there too, and under the int8 calibration, which records
    its input as the JAX package's calibration does (``blocks.calibrating``).
    """

    def __init__(self, levels: int, in_channels: int, features: int, block: str = 'basic',
                 stride: int = 1, level_root: bool = False, root_kernel_size: int = 1,
                 dilation: int = 1, root_residual: bool = False, children_channels: int = 0):
        super().__init__()
        block_cls = DLABasicBlock if block == 'basic' else DLABottleneck
        self.levels, self.stride, self.level_root = levels, stride, level_root
        self.project = in_channels != features
        if self.project:
            self.project_conv = nn.Conv2d(in_channels, features, 1, bias=False)
            self.BatchNorm_0 = bn2d(features)
        children_channels += in_channels if level_root else 0
        if levels == 1:
            self.tree1 = block_cls(in_channels, features, stride, dilation)
            self.tree2 = block_cls(features, features, 1, dilation)
            self.root = Root(2 * features + children_channels, features, root_kernel_size,
                             root_residual)
        else:
            common = dict(block=block, root_kernel_size=root_kernel_size, dilation=dilation,
                          root_residual=root_residual)
            self.tree1 = Tree(levels - 1, in_channels, features, stride=stride, **common)
            self.tree2 = Tree(levels - 1, features, features, stride=1,
                              children_channels=children_channels + features, **common)

    def forward(self, x, children=None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.BatchNorm_0(self.project_conv(bottom)) if self.project else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        if self.project and self.training:
            with torch.no_grad():
                self.BatchNorm_0(self.project_conv(bottom))
        elif self.project and is_calibrating():  # the int8 calibration records its input
            self.project_conv(bottom)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """The DLA trunk returning the levels in ``out_indices``."""

    def __init__(self, levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512), block: str = 'basic',
                 residual_root: bool = False, out_indices: Tuple[int, ...] = (0, 1, 2, 3, 4, 5),
                 in_channels: int = 3):
        super().__init__()
        ch = list(channels)
        self.out_indices = tuple(out_indices)
        self.out_channels = [ch[i] for i in self.out_indices]
        self.base_layer = nn.Conv2d(in_channels, ch[0], 7, padding=3, bias=False)
        self.BatchNorm_0 = bn2d(ch[0])
        self.level0_conv = nn.Conv2d(ch[0], ch[0], 3, padding=1, bias=False)
        self.BatchNorm_1 = bn2d(ch[0])
        self.level1_conv = nn.Conv2d(ch[0], ch[1], 3, 2, padding=1, bias=False)
        self.BatchNorm_2 = bn2d(ch[1])
        for i in range(2, 6):
            self.add_module(f'level{i}', Tree(levels[i], ch[i - 1], ch[i], block, 2,
                                              level_root=i > 2,
                                              root_residual=residual_root))

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.base_layer(x)))
        y = F.relu(self.BatchNorm_1(self.level0_conv(x)))
        outs = [y]
        y = F.relu(self.BatchNorm_2(self.level1_conv(y)))
        outs.append(y)
        for i in range(2, 6):
            y = getattr(self, f'level{i}')(y)
            outs.append(y)
        return [outs[i] for i in self.out_indices]


@BACKBONE_DICT.register_module
def dlanet(depth: int = 34, **kwargs) -> DLA:
    """Factory with the JAX package's keyword API (``out_indices``,
    ``residual_root``; other keys are ignored, as there)."""
    levels, channels, block = DLA_SPECS[depth]
    kwargs = {k: v for k, v in kwargs.items() if k in ('out_indices', 'residual_root')}
    if 'out_indices' in kwargs:
        kwargs['out_indices'] = tuple(kwargs['out_indices'])
    return DLA(levels=levels, channels=channels, block=block, **kwargs)
