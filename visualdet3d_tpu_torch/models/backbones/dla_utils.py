"""DLA upsampling neck with deformable convolutions (counterpart of
``visualdet3d_tpu/models/backbones/dla_utils.py``): IDAUp / DLAUp /
DLASegUpsample, NCHW in channels_last.

Every aggregation node is a ``ModulatedDeformConv`` (the CUDA DCN kernel on
the card: 16 of them in the KM3D neck); the upsample is bilinear with
half-pixel centres (``jax.image.resize`` 'bilinear' in the JAX package,
``F.interpolate(align_corners=False)`` here).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.models.blocks import ModulatedDeformConv, bn2d


class DeformConvBlock(nn.Module):
    """DCN + BN + ReLU node."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.ModulatedDeformConv_0 = ModulatedDeformConv(in_channels, features, 3)
        self.BatchNorm_0 = bn2d(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.ModulatedDeformConv_0(x)))


def _bilinear_up(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode='bilinear', align_corners=False)


class IDAUp(nn.Module):
    """Iterative deep aggregation over a list of feature maps: for
    i in (startp, endp), ``proj_{j}`` of layer i, upsampled, added to layer
    i - 1 and merged by ``node_{j}`` (j = i - startp)."""

    def __init__(self, out_features: int, in_channels: Sequence[int],
                 up_factors: Sequence[int]):
        super().__init__()
        self.up_factors = [int(f) for f in up_factors]
        for j in range(1, len(in_channels)):
            self.add_module(f'proj_{j}', DeformConvBlock(in_channels[j], out_features))
            self.add_module(f'node_{j}', DeformConvBlock(out_features, out_features))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int):
        layers = list(layers)
        for i in range(startp + 1, endp):
            j = i - startp
            x = _bilinear_up(getattr(self, f'proj_{j}')(layers[i]), self.up_factors[j])
            layers[i] = getattr(self, f'node_{j}')(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Pyramid of IDAUp merges over the levels from ``startp`` on (absolute
    indexing into the full level list, as the JAX package does)."""

    def __init__(self, startp: int, channels: Sequence[int], scales: Sequence[int]):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        scales = np.array(scales, int)
        in_channels = list(channels)
        for i in range(len(channels) - 1):
            j = -i - 2
            self.add_module(f'ida_{i}', IDAUp(channels[j], in_channels[j:],
                                              (scales[j:] // scales[j]).tolist()))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers: List[torch.Tensor]):
        layers = list(layers)
        out = [layers[-1]]
        for i in range(len(layers) - self.startp - 1):
            layers = getattr(self, f'ida_{i}')(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out


class DLASegUpsample(nn.Module):
    """DLAUp + a final IDAUp -> the stride-``down_ratio`` feature map."""

    def __init__(self, input_channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 down_ratio: int = 4, last_level: int = 5, out_channel: int = 64):
        super().__init__()
        self.first_level = int(np.log2(down_ratio))
        self.last_level = last_level
        channels = list(input_channels)
        scales = [2 ** i for i in range(len(channels[self.first_level:]))]
        self.dla_up = DLAUp(self.first_level, channels[self.first_level:], scales)
        out_channel = out_channel or channels[self.first_level]
        n = last_level - self.first_level
        self.ida_up = IDAUp(out_channel, channels[self.first_level:last_level],
                            [2 ** i for i in range(n)])
        self.out_channels = out_channel

    def forward(self, tensors: List[torch.Tensor]):
        outs = self.dla_up(list(tensors))
        y = [outs[i] for i in range(self.last_level - self.first_level)]
        return self.ida_up(y, 0, len(y))[-1]
