"""MonoDepth (counterpart of ``visualdet3d_tpu/models/detectors/monodepth.py``):
DORN-style log-depth regression by a U-Net on a ResNet trunk. Each decoder
block upsamples by 2 (bilinear), concatenates the skip connection before
the upsampled map, and runs a ``DoubleConv``: ``LookGround`` (calibration
aware, on the first two blocks), a 5x5 conv, BatchNorm, ReLU, a modulated
deformable conv (the CUDA kernels on the card, forward and backward),
BatchNorm, ReLU. Outputs at strides 8, 4 and 1 (``scale_8``, ``scale_4``,
``scale_1``, log depth about a precomputed prior); the loss is the
scale-invariant log loss plus the edge-aware smoothness.

The dtypes are the JAX package's, not a policy's. In bf16 inference (a bf16
copy of the weights, bf16 images, P2 f32) ``LookGround`` returns f32 (its
ground-plane disparity is computed from the f32 P2), so from the first
decoder block on every conv and DCN computes in f32 (flax promotes a bf16
kernel against an f32 input; the concatenations carry the f32 on): the
DCNs take the f32 forward kernel. Under the mixed-precision training policy
every conv input is cast to bf16 and so every DCN computes in bf16. Hence
the decoder's convs are ``FlaxConv2d``, and ``ModulatedDeformConv``
computes in its offset conv's dtype.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.models.backbones.resnet import resnet
from visualdet3d_tpu_torch.models.blocks import (
    FlaxConv2d, LookGround, ModulatedDeformConv, bn2d, channels_last_, flax_default_init_)
from visualdet3d_tpu_torch.models.heads.monodepth_loss import (
    reshape_depth, si_log_loss, smooth_loss)
from visualdet3d_tpu_torch.models.quant import INT8_REFUSAL, InferenceMixin
from visualdet3d_tpu_torch.registry import DETECTOR_DICT

NEUTRAL_PRIOR = math.log(15.0)  # log depth (m) without a precomputed prior


class DoubleConv(nn.Module):
    """(``LookGround`` on P2 with rows 0-1 divided by the stride) -> 5x5
    conv -> BN -> ReLU -> DCN -> BN -> ReLU."""

    def __init__(self, in_channels: int, features: int, mid_features: int = 0,
                 look_ground: bool = False):
        super().__init__()
        mid = mid_features or features
        self.look_ground = look_ground
        if look_ground:
            self.LookGround_0 = LookGround(in_channels, stride_scale=1.0)
        self.Conv_0 = FlaxConv2d(in_channels, mid, 5, padding=2)
        self.BatchNorm_0 = bn2d(mid)
        self.ModulatedDeformConv_0 = ModulatedDeformConv(mid, features, 3)
        self.BatchNorm_1 = bn2d(features)

    def forward(self, x, P2: Optional[torch.Tensor] = None, scale: float = 1.0):
        if self.look_ground and P2 is not None:
            x = self.LookGround_0(x, torch.cat([P2[:, 0:2] / scale, P2[:, 2:]], dim=1))
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return F.relu(self.BatchNorm_1(self.ModulatedDeformConv_0(x)))


class Up(nn.Module):
    """x2 bilinear upsample (half-pixel centres, ``jax.image.resize``'s),
    the skip concatenated before it, ``DoubleConv``."""

    def __init__(self, in_channels: int, features: int, mid_features: int = 0,
                 look_ground: bool = False):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(in_channels, features, mid_features, look_ground)

    def forward(self, x1, x2=None, P2=None, scale: float = 1.0):
        x1 = F.interpolate(x1, scale_factor=2, mode='bilinear', align_corners=False)
        x = x1 if x2 is None else torch.cat([x2, x1], dim=1)
        return self.DoubleConv_0(x, P2, scale)


class UNetCore(nn.Module):
    """The ResNet trunk (strides 4, 8, 16, 32) and the decoder: ``up0``
    (LookGround at stride 16, 5x5 conv to 768, DCN to 256), ``up1``
    (stride 8, 384, 64), the ``out_scale_8`` head, ``up2`` (stride 4, 64,
    no LookGround), ``out_scale_4``, a x4 bilinear resize and ``outc``.
    Takes NCHW images and P2 [B, 3, 4]; returns the three maps, NCHW."""

    def __init__(self, backbone_cfg: dict, n_classes: int = 1, look_ground: bool = True):
        super().__init__()
        self.ResNet_0 = resnet(**dict(backbone_cfg))
        c3, c4, c5, c6 = self.ResNet_0.out_channels
        self.up0 = Up(c6 + c5, 256, mid_features=512 + 256, look_ground=look_ground)
        self.up1 = Up(256 + c4, 64, mid_features=256 + 128, look_ground=look_ground)
        self.out_scale_8 = FlaxConv2d(64, n_classes, 3, padding=1)
        self.up2 = Up(64 + c3, 64)
        self.out_scale_4 = FlaxConv2d(64, n_classes, 3, padding=1)
        self.outc = FlaxConv2d(64, n_classes, 3, padding=1)

    def forward(self, x, P2=None) -> Dict[str, torch.Tensor]:
        x3, x4, x5, x6 = self.ResNet_0(x)
        y = self.up0(x6, x5, P2=P2, scale=32.0)
        y = self.up1(y, x4, P2=P2, scale=16.0)
        outs = {'scale_8': self.out_scale_8(y)}
        y = self.up2(y, x3)
        outs['scale_4'] = self.out_scale_4(y)
        y = F.interpolate(y, scale_factor=4, mode='bilinear', align_corners=False)
        outs['scale_1'] = self.outc(y)
        return outs


def prior_mean_of(preprocessed_path: str) -> float:
    """The mean log depth of ``<preprocessed_path>/training``'s
    ``log_depth_sum.npy`` / ``log_depth_solid.npy`` (``cli/depth_precompute.py``),
    else log(15 m)."""
    sum_file = os.path.join(preprocessed_path, 'training', 'log_depth_sum.npy')
    num_file = os.path.join(preprocessed_path, 'training', 'log_depth_solid.npy')
    if os.path.isfile(sum_file) and os.path.isfile(num_file):
        return float(np.sum(np.load(sum_file)) / np.sum(np.load(num_file)))
    return NEUTRAL_PRIOR


def resize_images(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(images, (B, h, w, C), 'bilinear')`` of NHWC
    images: the triangle kernel widened by the factor when shrinking
    (antialiased), the identity at the same size."""
    if tuple(images.shape[1:3]) == tuple(hw):
        return images
    out = F.interpolate(images.permute(0, 3, 1, 2), size=tuple(hw), mode='bilinear',
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


@DETECTOR_DICT.register_module
class MonoDepth(InferenceMixin):
    """The MonoDepth system (``configs/monodepth.py``): the network with its
    weights on the system's device, ``loss`` and ``predict``."""

    OUTPUTS = ('scale_8', 'scale_4', 'scale_1')

    def __init__(self, network_cfg, device: Optional[Union[str, torch.device]] = None):
        self.cfg = network_cfg
        self.device = resolve_device(device)
        self.max_depth = network_cfg.get('max_depth', 50)
        self.output_channel = network_cfg.get('output_channel', 1)
        self.SI_loss_lambda = network_cfg.get('SI_loss_lambda', 0.3)
        self.smooth_weight = network_cfg.get('smooth_loss_weight', 0.003)
        self.minor_weight = network_cfg.get('minor_weight', 0.0)
        self.obj_types = list(network_cfg.get('obj_types', []))
        self.prior_mean = prior_mean_of(network_cfg.get('preprocessed_path', ''))
        net = UNetCore(dict(network_cfg.backbone), n_classes=self.output_channel)
        flax_default_init_(net, torch.Generator().manual_seed(0))
        self.net = channels_last_(net.to(self.device)).eval()
        self._init_inference_cache()

    def _images(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[B, H, W, 3] images -> NCHW channels_last in ``dtype`` on the device."""
        images = torch.as_tensor(images, device=self.device)
        return images.to(dtype).contiguous().permute(0, 3, 1, 2)

    def _net_inputs(self, image_hw, batch_size: int = 1):
        img = torch.zeros((batch_size, *image_hw, 3), device=self.device)
        P2 = torch.eye(3, 4, device=self.device).expand(batch_size, 3, 4)
        return self._images(img, torch.float32), P2

    def loss(self, images, P2, gts, apply_fn: Optional[Callable] = None):
        """The loss of a batch: ``(loss, loss_dict)``, differentiable in the
        network's parameters. images [B, H, W, 3], P2 [B, 3, 4], gts [B, H,
        W] sparse metric depth (0 where there is no return). The network
        runs in train mode (``apply_fn(net, images, P2=P2)``: the
        mixed-precision policy passes its own, which casts the images, not
        P2) and returns to eval mode; the maps are upcast to f32. Each
        output's term is the SI-log loss of ``exp(prior + map)`` against the
        ground truth max-pooled to its size plus ``smooth_loss_weight`` times
        the smoothness against the images resized to it; ``scale_1``'s
        counts once, the others ``minor_weight`` times."""
        apply_fn = apply_fn or (lambda net, x, P2: net(x, P2=P2))
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        gts = torch.as_tensor(gts, dtype=torch.float32, device=self.device)
        self.net.train()
        try:
            feat = apply_fn(self.net, self._images(images, torch.float32), P2=P2)
        finally:
            self.net.eval()
        loss = 0.0
        for key in self.OUTPUTS:
            out = feat[key].float().permute(0, 2, 3, 1)
            depth_prediction = torch.exp(self.prior_mean + out[..., 0])
            shape = tuple(depth_prediction.shape[1:3])
            term = si_log_loss(depth_prediction, reshape_depth(gts, shape), self.max_depth,
                               self.SI_loss_lambda) \
                + self.smooth_weight * smooth_loss(out, resize_images(images, shape))
            loss = loss + (term if key == 'scale_1' else self.minor_weight * term)
        return loss, dict(total_loss=loss)

    @torch.inference_mode()
    def predict_raw(self, images, P2) -> Dict[str, torch.Tensor]:
        """[B, H, W, 3] images, P2 [B, 3, 4] -> the three log-depth maps,
        NHWC, in the dtypes the inference network computes them in."""
        if self.cfg.get('inference_dtype', 'float32') == 'int8':
            raise NotImplementedError(
                f'MonoDepth: {INT8_REFUSAL}')
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        out = self.inference_net()(self._images(images, self.inference_dtype()), P2)
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}

    @torch.inference_mode()
    def predict(self, images, P2) -> Dict[str, torch.Tensor]:
        """dict(target=[B, H, W, 1] metric depth, ``exp(prior + scale_1)``)."""
        return {'target': torch.exp(self.prior_mean + self.predict_raw(images, P2)['scale_1'])}
