"""Reusable model blocks, the stereo, DCN and GAC subset (counterpart of
``visualdet3d_tpu/models/blocks.py``).

Modules take NCHW tensors and keep activations in ``torch.channels_last``
memory format. Submodule names mirror the flax auto-names (``Conv_0``,
``BatchNorm_0``, ...) so that the weight bridge (``convert.py``) maps a
flax tree onto a ``state_dict`` path for path.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.ops.deform_conv import modulated_deform_conv
from visualdet3d_tpu_torch.ops.sampling import grid_sample


class _FlaxBatchNorm:
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over every dimension
    but the channels (dim 1), mixed into ``nn.BatchNorm2d``/``3d``.

    In train mode it normalises with the batch statistics (the biased
    variance, as both frameworks do; ``F.batch_norm`` and its backward) and
    updates the running statistics as flax does: ``r = 0.9 r + 0.1 s`` with
    the batch mean and the *biased* batch variance ``E[x^2] - E[x]^2``,
    computed in f32 and clipped at 0 (``nn.BatchNorm2d``/``3d`` would take
    the unbiased one, n/(n-1) larger). ``freeze_stats`` skips the update
    (a recomputed forward, ``models/backbones/resnet.py``'s remat). In eval
    mode it normalises with the running statistics. The output keeps the
    input's dtype: under the mixed-precision policy a bf16 input with bf16
    scale and bias gives a bf16 output while the statistics and the running
    buffers stay f32. Scale and bias enter in f32 in both modes, so the
    normalisation is computed in f32 and rounded once, as flax promotes them
    (an all-bf16 ``F.batch_norm`` on the CPU rounds the per-channel factors
    to bf16, an error that does not average out across a channel). An f64
    network (a reference step) computes in f64 throughout.
    """

    freeze_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if (self.weight.dtype == self.running_mean.dtype
                    == torch.promote_types(x.dtype, self.weight.dtype)):
                return super().forward(x)  # f32, or a cast inference copy on its own dtype
            # flax promotes: bf16 scale and bias against f32 statistics (the
            # policy), or a cast copy's bf16 parameters against an f32 input
            # (GAC's regression tower in bf16 inference); the output keeps x's dtype
            return F.batch_norm(x, self.running_mean.float(), self.running_var.float(),
                                self.weight.float(), self.bias.float(), False, 0.0, self.eps)
        acc = torch.promote_types(x.dtype, torch.float32)  # f64 stays f64 (a reference step)
        y = F.batch_norm(x, None, None, self.weight.to(acc), self.bias.to(acc), True, 0.0,
                         self.eps)
        if not self.freeze_stats:
            with torch.no_grad():
                xf = x.to(acc)
                dims = (0, *range(2, x.dim()))
                mean = xf.mean(dim=dims)
                var = ((xf * xf).mean(dim=dims) - mean * mean).clamp(min=0.0)
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
                self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """flax ``BatchNorm`` on NCHW (see ``_FlaxBatchNorm``)."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """flax ``BatchNorm`` on NCDHW (see ``_FlaxBatchNorm``)."""


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block, the flax-style BatchNorms of ``module`` do not
    update their running statistics."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxBatchNorm)]
    for m in bns:
        m.freeze_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.freeze_stats = False


class ChannelDropout(nn.Module):
    """flax ``Dropout(rate, broadcast_dims=(1, 2))`` on NHWC: in train mode
    whole channels of an NCHW tensor are dropped and the survivors scaled by
    1 / (1 - rate), the mask drawn from ``generator`` (a ``torch.Generator``
    on the input's device, which the caller sets for a training forward;
    None leaves the input as it is, as flax's deterministic mode)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.generator is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2),
                          generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def bn2d(features: int) -> BatchNorm2d:
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` (see ``_FlaxBatchNorm``)."""
    return BatchNorm2d(features, eps=1e-5, momentum=0.1)


def bn3d(features: int) -> BatchNorm3d:
    """The same on NCDHW."""
    return BatchNorm3d(features, eps=1e-5, momentum=0.1)


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


# the dtype the mixed-precision policy casts every conv input to (None
# outside it): the counterpart of the JAX package's interceptor, which casts
# the input of every flax Conv under ``_mixed_precision_interceptor``
_CONV_INPUT_DTYPE: contextvars.ContextVar = contextvars.ContextVar('conv_input_dtype',
                                                                  default=None)


@contextlib.contextmanager
def conv_inputs_cast_to(dtype: torch.dtype):
    """Within the block, every :class:`FlaxConv2d` casts its input to
    ``dtype`` (the mixed-precision policy, ``pipelines/train_state.py``)."""
    token = _CONV_INPUT_DTYPE.set(dtype)
    try:
        yield
    finally:
        _CONV_INPUT_DTYPE.reset(token)


class FlaxConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's dtypes, for modules whose input dtype may
    differ from their weights': under the mixed-precision policy the input
    is cast to the policy's dtype (:func:`conv_inputs_cast_to`); otherwise
    input, weight and bias are promoted to a common dtype (flax's
    ``promote_dtype``: a bf16 inference copy fed an f32 tensor runs in
    f32). An ``nn.Conv2d`` for the hooks of BN folding and calibration."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _CONV_INPUT_DTYPE.get() or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


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

    The dtypes are flax's: the offset conv is a :class:`FlaxConv2d`, and the
    deformable conv computes in its dtype (the policy's under the
    mixed-precision policy, else the promoted dtype of the input and the
    weights), so a bf16 inference copy fed an f32 map (MonoDepth's decoder
    after ``LookGround``) runs the f32 kernel, as the JAX op's dtype is its
    input's.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        k = kernel_size * kernel_size
        self.pad = dilation * (kernel_size - 1) // 2
        self.Conv_0 = FlaxConv2d(in_channels, 3 * k, kernel_size, padding=self.pad,
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
        dtype = om.dtype
        out = modulated_deform_conv(x.to(dtype).permute(0, 2, 3, 1), om[..., :2 * k],
                                    torch.sigmoid(om[..., 2 * k:]),
                                    self.weight.to(dtype).permute(2, 3, 1, 0),
                                    self.bias.to(dtype), padding=self.pad,
                                    dilation=self.dilation, train=self.training)
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


def linspace(start: float, stop: float, num: int, dtype: torch.dtype,
             device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=dtype)`` rounded as JAX rounds
    it: ``step = iota / (num - 1)`` and ``start * (1 - step) + stop * step``
    in ``dtype``, each operation rounded, the last point ``stop`` (in bf16
    ``torch.linspace`` differs from it at about half the points of 80)."""
    t = functools.partial(torch.tensor, dtype=dtype, device=device)
    if num == 1:
        return t([start])
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / t(div)
    out = t(start) * (1 - step) + t(stop) * step
    return torch.cat([out, t([stop])])


def ground_plane_disparity(feat_shape, P2: torch.Tensor, baseline: float,
                           relative_elevation: float, stride_scale: float,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-row disparity of the analytic ground plane at feature resolution,
    ``fy * baseline * (v - cy) / |fy * elev + Ty|`` (ReLU'd) with the P2
    intrinsics divided by the feature stride; ``feat_shape`` starts with
    (B, H, W). The rows are ``dtype`` (the features'), P2's dtype carries
    the rest: with an f32 P2 the result is f32 whatever ``dtype`` is, as in
    the JAX package. Returns [B, H, W]."""
    b, h, w = feat_shape[0], feat_shape[1], feat_shape[2]
    fy = P2[:, 1, 1] / stride_scale
    cy = P2[:, 1, 2] / stride_scale
    ty = P2[:, 1, 3]
    rows = torch.arange(h, dtype=dtype, device=P2.device)
    yy = rows[None, :, None].expand(b, h, w)
    disparity = fy[:, None, None] * baseline * (yy - cy[:, None, None]) / (
        torch.abs(fy[:, None, None] * relative_elevation + ty[:, None, None]) + 1e-10)
    return F.relu(disparity)


class LookGround(nn.Module):
    """Ground-aware feature sampling: a 1-channel 3x3 conv predicts a
    disparity correction (tanh, 5% of its gradient kept, x 0.1); the
    sampling grid (``linspace`` in the features' dtype) is shifted down
    toward the ground-contact row by an analytic shift and the correction;
    [ground-plane disparity, features] are sampled there (border,
    align_corners), projected by a 1x1 conv and added to the features
    through the zero-initialised ``alpha``, then ReLU.

    The dtypes are the JAX package's, not a policy's: with an f32 P2 the
    disparity and the shift are f32, so the grid and the sampled tensor
    are f32 whatever the features are; the 1x1 conv then runs in f32 in
    bf16 inference (flax's promotion), in bf16 under the mixed-precision
    policy (its input cast), and so does everything after it.
    """

    def __init__(self, features: int, baseline: float = 0.54,
                 relative_elevation: float = 1.65, stride_scale: float = 16.0):
        super().__init__()
        self.baseline, self.relative_elevation = baseline, relative_elevation
        self.stride_scale = stride_scale
        self.Conv_0 = FlaxConv2d(features, 1, 3, padding=1)
        self.Conv_1 = FlaxConv2d(features + 1, features, 1)
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
        """x: NCHW features (channels_last), P2 [B, 3, 4]."""
        b, _, h, w = x.shape
        disp_pred = torch.tanh(self.Conv_0(x))[:, 0]  # [B, H, W]
        # mostly stop-gradient: 5% of the gradient flows
        disp_pred = 0.1 * (0.05 * disp_pred + 0.95 * disp_pred.detach())
        shape = (b, h, w)
        disparity = ground_plane_disparity(shape, P2, self.baseline, self.relative_elevation,
                                           self.stride_scale, dtype=x.dtype)
        x_base = linspace(-1.0, 1.0, w, x.dtype, x.device)[None, None, :].expand(shape)
        y_base = linspace(-1.0, 1.0, h, x.dtype, x.device)[None, :, None].expand(shape)
        # analytic downward shift toward the ground-contact row
        h_mean = 1.535
        rows = torch.arange(h, dtype=x.dtype, device=x.device)
        yy = rows[None, :, None].expand(shape)
        cy = (P2[:, 1, 2] / self.stride_scale)[:, None, None]
        y_shift = F.relu(h_mean * (yy - cy) /
                         (2 * (self.relative_elevation - 0.5 * h_mean))) / (h * 0.5)
        flow_y = y_base + y_shift + disp_pred
        flow = torch.stack([x_base.to(flow_y.dtype), flow_y], dim=-1)

        dtype = torch.promote_types(disparity.dtype, x.dtype)
        features = torch.cat([disparity[:, None].to(dtype), x.to(dtype)], dim=1)
        sampled = grid_sample(features.permute(0, 2, 3, 1), flow.to(dtype),
                              padding_mode='border', align_corners=True)
        extracted = self.Conv_1(sampled.permute(0, 3, 1, 2))
        return F.relu(x + extracted * self.alpha)
