"""ResNet backbone family (counterpart of
``visualdet3d_tpu/models/backbones/resnet.py``), NCHW in channels_last.

Depth in {18, 34, 50, 101, 152}; ``num_stages``/``out_indices`` truncate and
tap stages, ``dilations`` per stage, ``frozen_stages`` as a prefix freeze
(``detach`` where the JAX package has ``stop_gradient``), ``norm_eval``
(BatchNorm stays in eval mode while the module trains), the space-to-depth
stem and ``remat`` (each residual block recomputed in the backward instead
of keeping its activations). Submodule names mirror the flax names.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Sequence

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from visualdet3d_tpu_torch.models.blocks import bn2d, frozen_running_stats
from visualdet3d_tpu_torch.registry import BACKBONE_DICT

RESNET_SPECS = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut."""
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        # symmetric padding == torch/pretrained parity (flax pads explicitly too)
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, stride, padding=dilation,
                                dilation=dilation, bias=False)
        self.BatchNorm_0 = bn2d(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.BatchNorm_1 = bn2d(features)
        self.project = stride != 1 or in_channels != features
        if self.project:
            self.Conv_2 = nn.Conv2d(in_channels, features, 1, stride, bias=False)
            self.BatchNorm_2 = bn2d(features)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        identity = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck; ``features`` is the inner width."""
    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        out_features = features * self.expansion
        self.Conv_0 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.BatchNorm_0 = bn2d(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, stride, padding=dilation,
                                dilation=dilation, bias=False)
        self.BatchNorm_1 = bn2d(features)
        self.Conv_2 = nn.Conv2d(features, out_features, 1, bias=False)
        self.BatchNorm_2 = bn2d(out_features)
        self.project = stride != 1 or in_channels != out_features
        if self.project:
            self.Conv_3 = nn.Conv2d(in_channels, out_features, 1, stride, bias=False)
            self.BatchNorm_3 = bn2d(out_features)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        identity = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(out + identity)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NCHW [B, C, H, W] -> [B, 4C, H/2, W/2], channel order (p, q, c) as in
    the JAX stem's ``reshape(b,h/2,2,w/2,2,c).transpose(0,1,3,2,4,5)``.
    Returns a channels_last tensor."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return y.permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """Multi-stage ResNet trunk returning the stages in ``out_indices``.

    Output channels per stage: basic (64, 128, 256, 512); bottleneck
    (256, 512, 1024, 2048). Strides 4, 8, 16, 32.
    """

    def __init__(self, depth: int = 101, num_stages: int = 4,
                 out_indices: Sequence[int] = (3,), frozen_stages: int = -1,
                 dilations: Sequence[int] = (1, 1, 1, 1), norm_eval: bool = False,
                 s2d_stem: bool = False, remat: bool = False, in_channels: int = 3):
        super().__init__()
        block_type, stage_blocks = RESNET_SPECS[depth]
        block_cls = BasicBlock if block_type == 'basic' else Bottleneck
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.s2d_stem = s2d_stem
        self.remat = remat
        if s2d_stem:
            # 4x4/s1 conv on the 2x2 space-to-depth image: the flax stem's
            # asymmetric padding [(2, 1), (2, 1)] is an explicit F.pad
            self.conv1 = nn.Conv2d(4 * in_channels, 64, 4, 1, padding=0, bias=False)
        else:
            self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, padding=3, bias=False)
        self.BatchNorm_0 = bn2d(64)

        self.stage_names: List[List[str]] = []
        self.out_channels: List[int] = []
        channels, features = 64, 64
        for stage_idx, num_blocks in enumerate(stage_blocks[:num_stages]):
            stride = 1 if stage_idx == 0 else 2
            dilation = dilations[stage_idx] if stage_idx < len(dilations) else 1
            if dilation > 1:
                stride = 1
            names = []
            for block_idx in range(num_blocks):
                name = f'layer{stage_idx + 1}_{block_idx}'
                self.add_module(name, block_cls(channels, features,
                                                stride if block_idx == 0 else 1, dilation))
                channels = features * block_cls.expansion
                names.append(name)
            self.stage_names.append(names)
            if stage_idx in self.out_indices:
                self.out_channels.append(channels)
            features *= 2

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x):
        if self.s2d_stem:
            x = self.conv1(F.pad(space_to_depth(x), (2, 1, 2, 1)))
        else:
            x = self.conv1(x)
        x = F.relu(self.BatchNorm_0(x))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage_idx, names in enumerate(self.stage_names):
            for name in names:
                block = getattr(self, name)
                if remat:
                    # the backward recomputes the block's forward; its
                    # BatchNorms update their running statistics once, in
                    # the first forward (as the JAX package's nn.remat)
                    x = checkpoint(block, x, use_reentrant=False,
                                   context_fn=functools.partial(_remat_contexts, block))
                else:
                    x = block(x)
            if self.frozen_stages >= stage_idx + 1:
                x = x.detach()
            if stage_idx in self.out_indices:
                outs.append(x)
        return outs


def _remat_contexts(block: nn.Module):
    """``checkpoint``'s contexts: the forward as it is, the recompute with
    the block's running statistics frozen."""
    return contextlib.nullcontext(), frozen_running_stats(block)


def convert_stem_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """Losslessly rearrange an OIHW [O, C, 7, 7] stride-2 stem kernel into
    the equivalent [O, 4C, 4, 4] space-to-depth kernel.

    y[i] = sum_a w7[a] x[2i + a - 3]; with 2x2 blocks t[u, (p, c)] = x[2u + p],
    tap (dj, p) reads a = 2*dj + p - 1 (dj in 0..3 is block offset dj - 2
    under padding (2, 1)).
    """
    o, c, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f'expected a 7x7 stem kernel, got {kh}x{kw}')
    w4 = w7.new_zeros((o, 4 * c, 4, 4))
    for dj in range(4):
        for p in range(2):
            a = 2 * dj + p - 1
            if not 0 <= a < 7:
                continue
            for dk in range(4):
                for q in range(2):
                    b = 2 * dk + q - 1
                    if not 0 <= b < 7:
                        continue
                    w4[:, (p * 2 + q) * c:(p * 2 + q + 1) * c, dj, dk] = w7[:, :, a, b]
    return w4


@BACKBONE_DICT.register_module
def resnet(**kwargs) -> ResNet:
    """Factory with the JAX package's keyword API. ``pretrained`` is loaded
    outside."""
    num_stages = kwargs.get('num_stages', 4)
    kwargs.setdefault('dilations', tuple([1] * num_stages))
    valid = {'depth', 'num_stages', 'out_indices', 'frozen_stages',
             'dilations', 'norm_eval', 's2d_stem', 'remat'}
    kwargs = {k: v for k, v in kwargs.items() if k in valid}
    for key in ('out_indices', 'dilations'):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    return ResNet(**kwargs)
