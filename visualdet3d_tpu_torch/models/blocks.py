"""Reusable model blocks, stereo and DCN subset (counterpart of
``visualdet3d_tpu/models/blocks.py``).

Modules take NCHW tensors and keep activations in ``torch.channels_last``
memory format. Submodule names mirror the flax auto-names (``Conv_0``,
``BatchNorm_0``, ...) so that the weight bridge (``convert.py``) maps a
flax tree onto a ``state_dict`` path for path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.ops.deform_conv import modulated_deform_conv


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``.

    In eval mode: ``nn.BatchNorm2d`` on the running statistics. In train
    mode it normalises with the batch statistics (the biased variance, as
    both frameworks do; ``F.batch_norm`` and its backward) and updates the
    running statistics as flax does: ``r = 0.9 r + 0.1 s`` with the batch
    mean and the *biased* batch variance ``E[x^2] - E[x]^2``, computed in
    f32 and clipped at 0 (``nn.BatchNorm2d`` would take the unbiased one,
    n/(n-1) larger). The output keeps the input's dtype: under the
    mixed-precision policy a bf16 input with bf16 scale and bias gives a
    bf16 output while the statistics and the running buffers stay f32.
    Scale and bias enter in f32, so the normalisation is computed in f32
    and rounded once, as flax promotes them (an all-bf16 ``F.batch_norm``
    on the CPU rounds the per-channel factors to bf16, an error that does
    not average out across a channel).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight.float(), self.bias.float(), True, 0.0,
                         self.eps)
        with torch.no_grad():
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        return y


def bn2d(features: int) -> BatchNorm2d:
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` (see ``BatchNorm2d``)."""
    return BatchNorm2d(features, eps=1e-5, momentum=0.1)


def same_padding(kernel_size: int, dilation: int = 1) -> int:
    """flax 'SAME' padding of a stride-1 conv with an odd kernel."""
    if kernel_size % 2 != 1:
        raise ValueError(f"'SAME' padding is symmetric only for odd kernels, got {kernel_size}")
    return dilation * (kernel_size - 1) // 2


class ConvBnReLU(nn.Module):
    """Conv (with bias, stride 1, 'SAME') + BatchNorm + optional ReLU."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3), dilation: int = 1,
                 groups: int = 1, relu: bool = True):
        super().__init__()
        pad = tuple(same_padding(k, dilation) for k in kernel_size)
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size, padding=pad,
                                dilation=dilation, groups=groups)
        self.BatchNorm_0 = bn2d(features)
        self.relu = relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


def anchor_flatten(x: torch.Tensor, num_output_channel: int) -> torch.Tensor:
    """NCHW [B, A*C, H, W] -> [B, H*W*A, C]; locations outer, anchors inner
    (the JAX package's NHWC reshape). A view for a channels_last input."""
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, num_output_channel)


class GhostModule(nn.Module):
    """GhostNet cheap-conv block: a primary conv, then a depthwise conv on
    its output (``feature_group_count=init_ch``), concatenated."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 ratio: int = 2, dw_size: int = 3, stride: int = 1, relu: bool = True):
        super().__init__()
        init_ch = int(np.ceil(features / ratio))
        new_ch = init_ch * (ratio - 1)
        self.features, self.stride, self.relu = features, stride, relu
        self.Conv_0 = nn.Conv2d(in_channels, init_ch, kernel_size,
                                padding=same_padding(kernel_size), bias=False)
        self.BatchNorm_0 = bn2d(init_ch)
        self.Conv_1 = nn.Conv2d(init_ch, new_ch, dw_size, padding=same_padding(dw_size),
                                groups=init_ch, bias=False)
        self.BatchNorm_1 = bn2d(new_ch)

    def forward(self, x):
        if self.stride > 1:
            x = F.avg_pool2d(x, self.stride, self.stride)
        x1 = self.BatchNorm_0(self.Conv_0(x))
        if self.relu:
            x1 = F.relu(x1)
        x2 = self.BatchNorm_1(self.Conv_1(x1))
        if self.relu:
            x2 = F.relu(x2)
        return torch.cat([x1, x2], dim=1)[:, :self.features]


class ResGhostModule(nn.Module):
    """Ghost block whose output is concatenated after its own input."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 ratio: int = 3, dw_size: int = 3, relu: bool = True, stride: int = 1):
        super().__init__()
        if ratio <= 2:
            raise ValueError(f'ResGhostModule needs ratio > 2, got {ratio}')
        self.features, self.stride = features, stride
        self.GhostModule_0 = GhostModule(in_channels, features - in_channels, kernel_size,
                                         ratio - 1, dw_size, stride, relu)

    def forward(self, x):
        out = self.GhostModule_0(x)
        if self.stride > 1:
            x = F.avg_pool2d(x, self.stride, self.stride)
        return torch.cat([x, out], dim=1)[:, :self.features]


class ModulatedDeformConv(nn.Module):
    """DCNv2 'pack': a regular conv (``Conv_0``, 3K outputs, 'SAME') predicts
    per-tap (dy, dx) and the mask logits, then the deformable conv
    (``ops/deform_conv.py``, the CUDA kernel on the card) applies this
    module's own ``weight`` (OIHW) and ``bias``, which the weight bridge
    loads from the flax leaves ``kernel`` and ``bias``. The offset conv is
    zero-initialised, so the module starts as a plain conv with mask 0.5.
    Stride 1, the only one the ported models use (the flax module's strided
    form pads its offset conv asymmetrically).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        k = kernel_size * kernel_size
        self.pad = dilation * (kernel_size - 1) // 2
        self.Conv_0 = nn.Conv2d(in_channels, 3 * k, kernel_size, padding=self.pad,
                                dilation=dilation)
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The flax initialisers: offset conv zero, kernel he-normal (std
        sqrt(2 / fan_in)), bias zero."""
        self.Conv_0.weight.zero_()
        self.Conv_0.bias.zero_()
        std = (2.0 / self.weight[0].numel()) ** 0.5
        w = torch.randn(self.weight.shape, generator=generator) * std
        self.weight.copy_(w.to(self.weight.device))
        self.bias.zero_()

    def forward(self, x):
        """x: NCHW (channels_last) -> NCHW (channels_last)."""
        k = self.kernel_size * self.kernel_size
        om = self.Conv_0(x).permute(0, 2, 3, 1)
        offset = om[..., :2 * k]
        mask = torch.sigmoid(om[..., 2 * k:])
        out = modulated_deform_conv(x.permute(0, 2, 3, 1), offset, mask,
                                    self.weight.permute(2, 3, 1, 0), self.bias,
                                    padding=self.pad, dilation=self.dilation,
                                    train=self.training)
        return out.permute(0, 3, 1, 2)


def channels_last_(module: nn.Module) -> nn.Module:
    """Put every conv weight of ``module`` in channels_last (2-D) or
    channels_last_3d (3-D) memory format, in place; returns the module."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.to(memory_format=torch.channels_last)
        elif isinstance(m, nn.Conv3d):
            m.to(memory_format=torch.channels_last_3d)
    return module


@torch.no_grad()
def flax_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise like flax's defaults, from ``generator``: conv kernels
    lecun-normal (std sqrt(1/fan_in)), biases zero, BatchNorm identity
    (scale 1, bias 0, running mean 0, running var 1); a
    ``ModulatedDeformConv`` takes its own initialisers (zero offset conv)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) * (1.0 / fan_in) ** 0.5
            m.weight.copy_(w.to(m.weight.device))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    for m in module.modules():
        if isinstance(m, ModulatedDeformConv):
            m.reset_parameters(generator)
    return module
