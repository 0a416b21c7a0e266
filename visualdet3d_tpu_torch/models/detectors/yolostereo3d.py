"""YOLOStereo3D inference and training (counterpart of
``visualdet3d_tpu/models/detectors/yolostereo3d.py``).

Both eyes run through the trunk as one doubled batch, interleaved
(l0, r0, l1, r1, ...) as in the JAX package, so that the correlation kernel
reads each pair straight from the trunk's output. Modules take NCHW tensors
in channels_last memory format: a trunk feature permuted to NHWC is the
contiguous ``[2B, H, W, C]`` buffer the kernel takes, and the kernel's
``[B, H, W, D]`` volume permuted back is the channels_last input of the next
conv. The TPU's optimisation barriers around the eye stack have no
counterpart here. In training the correlation volumes are differentiable
(the CUDA backward kernel on the card), and the pyramid's train-only
disparity head gives the stereo focal loss its [B, H/4, W/4, 96] volume.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.models.backbones.resnet import BasicBlock, resnet
from visualdet3d_tpu_torch.models.blocks import (
    ResGhostModule, bn2d, bn3d, channels_last_, flax_default_init_)
from visualdet3d_tpu_torch.models.detectors.yolo3d import Yolo3DSystem
from visualdet3d_tpu_torch.models.heads.detection_3d_head import StereoHead
from visualdet3d_tpu_torch.models.heads.losses import stereo_focal_loss
from visualdet3d_tpu_torch.ops.cost_volume import concat_volume, correlation_volume_interleaved
from visualdet3d_tpu_torch.registry import DETECTOR_DICT


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class CostVolume3D(nn.Module):
    """Concat cost volume + 3-D conv aggregation at stride 16: a shared 1x1
    down-projection of both eyes, the concat volume over D = max_disp /
    scale, two 3x3x3 convs, and the (D, F) axes flattened to channels
    ``d*F + f``."""

    def __init__(self, in_channels: int, max_disp: int = 192,
                 downsample_scale: int = 16, psm_features: int = 8):
        super().__init__()
        self.num_disp = max_disp // downsample_scale
        self.Conv_0 = nn.Conv2d(in_channels, psm_features, 1)
        self.BatchNorm_0 = bn2d(psm_features)
        self.Conv_1 = nn.Conv3d(2 * psm_features, psm_features, 3, padding=1)
        self.BatchNorm_1 = bn3d(psm_features)
        self.Conv_2 = nn.Conv3d(psm_features, psm_features, 3, padding=1)
        self.BatchNorm_2 = bn3d(psm_features)

    @property
    def out_channels(self) -> int:
        return self.num_disp * self.Conv_2.out_channels

    def forward(self, both):
        """``both``: interleaved dual-eye features [2B, C, H, W]."""
        both = F.relu(self.BatchNorm_0(self.Conv_0(both)))
        b2, f, h, w = both.shape
        eyes = _nhwc(both).reshape(b2 // 2, 2, h, w, f)
        vol = concat_volume(eyes[:, 0], eyes[:, 1], self.num_disp)  # [B, D, H, W, 2F]
        vol = vol.permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d
        for conv, bn in ((self.Conv_1, self.BatchNorm_1), (self.Conv_2, self.BatchNorm_2)):
            vol = F.relu(bn(conv(vol)))
        b, f, dd, h, w = vol.shape
        # [B, F, D, H, W] -> [B, H, W, D*F] (channel d*F + f) -> channels_last NCHW
        return _nchw(vol.permute(0, 3, 4, 2, 1).reshape(b, h, w, dd * f))


class CostVolumePyramid(nn.Module):
    """Fuse the stride-4/8/16 volumes into stride-16 features; with
    ``disparity_head``, in train mode also the disparity volume: bilinear x2
    -> 3x3 conv (C/2) -> BN -> ReLU -> bilinear x2 -> 3x3 conv (C/4) -> BN
    -> ReLU -> 1x1 conv (96), [B, 96, H/4, W/4]."""

    def __init__(self, depth_channel_4: int, depth_channel_8: int, depth_channel_16: int,
                 disparity_head: bool = False):
        super().__init__()
        c4 = depth_channel_4
        c8 = 3 * c4 + depth_channel_8
        c16 = 3 * c8 + depth_channel_16
        self.ResGhostModule_0 = ResGhostModule(c4, 3 * c4, 3, ratio=3)
        self.BasicBlock_0 = BasicBlock(3 * c4, 3 * c4)
        self.ResGhostModule_1 = ResGhostModule(c8, 3 * c8, 3, ratio=3)
        self.BasicBlock_1 = BasicBlock(3 * c8, 3 * c8)
        self.ResGhostModule_2 = ResGhostModule(c16, 3 * c16, 3, ratio=3)
        self.BasicBlock_2 = BasicBlock(3 * c16, 3 * c16)
        self.out_channels = c = 3 * c16
        self.disparity_head = disparity_head
        if disparity_head:  # train-only; the flax names of the JAX package's train-mode init
            self.Conv_0 = nn.Conv2d(c, c // 2, 3, padding=1)
            self.BatchNorm_0 = bn2d(c // 2)
            self.Conv_1 = nn.Conv2d(c // 2, c // 4, 3, padding=1)
            self.BatchNorm_1 = bn2d(c // 4)
            self.Conv_2 = nn.Conv2d(c // 4, 96, 1)

    def forward(self, psv4, psv8, psv16):
        """-> (features [B, 1152, H/16, W/16], the disparity volume in train
        mode with the head, else None)."""
        x = F.avg_pool2d(self.ResGhostModule_0(psv4), 2, 2)
        x = torch.cat([self.BasicBlock_0(x), psv8], dim=1)
        x = F.avg_pool2d(self.ResGhostModule_1(x), 2, 2)
        x = torch.cat([self.BasicBlock_1(x), psv16], dim=1)
        features = self.BasicBlock_2(self.ResGhostModule_2(x))
        if not (self.training and self.disparity_head):
            return features, None
        # jax.image.resize's bilinear upsampling is F.interpolate's half-pixel rule
        y = F.interpolate(features, scale_factor=2, mode='bilinear', align_corners=False)
        y = F.relu(self.BatchNorm_0(self.Conv_0(y)))
        y = F.interpolate(y, scale_factor=2, mode='bilinear', align_corners=False)
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        return features, self.Conv_2(y)


class StereoMerging(nn.Module):
    """Correlation volumes at stride 4/8 (the CUDA kernels) + the concat
    volume at 16, fused by the pyramid and concatenated after the left
    stride-16 features; with the pyramid's disparity volume in training."""

    def __init__(self, channels_16: int, disparity_head: bool = False):
        super().__init__()
        self.disp4, self.disp8 = 96 // 4, 192 // 8
        self.CostVolume3D_0 = CostVolume3D(channels_16, max_disp=192, downsample_scale=16,
                                           psm_features=8)
        self.CostVolumePyramid_0 = CostVolumePyramid(self.disp4, self.disp8,
                                                     self.CostVolume3D_0.out_channels,
                                                     disparity_head)
        self.out_channels = channels_16 + self.CostVolumePyramid_0.out_channels

    def forward(self, feats):
        """``feats``: interleaved dual-eye trunk features [2B, C, H, W] at
        strides 4, 8 and 16. Returns (features, the disparity volume or
        None)."""
        psv4 = _nchw(correlation_volume_interleaved(_nhwc(feats[0]), self.disp4))
        psv8 = _nchw(correlation_volume_interleaved(_nhwc(feats[1]), self.disp8))
        psv16 = self.CostVolume3D_0(feats[2])
        psv_features, depth_output = self.CostVolumePyramid_0(psv4, psv8, psv16)
        left16 = feats[2][0::2]
        return torch.cat([left16, psv_features], dim=1), depth_output


class YoloStereo3DNet(nn.Module):
    """Dual-eye trunk (interleaved doubled batch) + StereoMerging +
    StereoHead. Takes NCHW images, returns (cls_preds [B, N, C+1],
    reg_preds [B, N, 12]) and, in train mode with ``disparity_head``, the
    disparity volume [B, 96, H/4, W/4] third."""

    def __init__(self, backbone_cfg: dict, head_cfg: dict, num_anchors: int,
                 disparity_head: bool = False):
        super().__init__()
        self.ResNet_0 = resnet(**dict(backbone_cfg))
        self.StereoMerging_0 = StereoMerging(self.ResNet_0.out_channels[2], disparity_head)
        self.StereoHead_0 = StereoHead(
            self.StereoMerging_0.out_channels,
            num_anchors=num_anchors,
            num_cls_output=head_cfg['num_cls_output'],
            num_reg_output=head_cfg['num_reg_output'],
            cls_feature_size=head_cfg.get('cls_feature_size', 256),
            reg_feature_size=head_cfg.get('reg_feature_size', 1408),
        )

    def forward(self, left_images, right_images):
        both = torch.stack([left_images, right_images], dim=1).flatten(0, 1)
        features, depth_output = self.StereoMerging_0(self.ResNet_0(both))
        cls_preds, reg_preds = self.StereoHead_0(features)
        if depth_output is None:
            return cls_preds, reg_preds
        return cls_preds, reg_preds, depth_output


@DETECTOR_DICT.register_module
class Stereo3D(Yolo3DSystem):
    """The YOLOStereo3D system: the network with its weights on the system's
    device, ``predict`` and, for a system built with ``training=True``,
    ``loss``.

    ``training=True`` builds the pyramid's train-only disparity head, which
    the weight bridge then loads from the JAX package's train-mode init; an
    inference system leaves it out and the bridge skips its leaves
    (``TRAIN_ONLY_PARAMS``). ``dropout`` switches the class tower's channel
    dropout in training (on by default; its masks come from the generator
    ``loss`` is given)."""

    # created by the JAX package's train-mode init, unused by inference
    TRAIN_ONLY_PARAMS = tuple(
        f'StereoMerging_0/CostVolumePyramid_0/{name}'
        for name in ('Conv_0', 'BatchNorm_0', 'Conv_1', 'BatchNorm_1', 'Conv_2'))

    def __init__(self, network_cfg, device: Optional[Union[str, torch.device]] = None,
                 training: bool = False):
        super().__init__(network_cfg, device)
        self.for_training = training
        self.dropout = True
        net = YoloStereo3DNet(dict(network_cfg.backbone), dict(self.layer_cfg),
                              self.anchors.num_anchors, disparity_head=training)
        flax_default_init_(net, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for conv in net.StereoHead_0.prediction_convs():
                conv.weight.zero_()
                conv.bias.zero_()
        self.net = channels_last_(net.to(self.device)).eval()

    def bridge_skip(self):
        return () if self.for_training else self.TRAIN_ONLY_PARAMS

    # the prediction convs stay in floats unless cfg.int8_all
    int8_deny = (('StereoHead_0', 'Conv_0'), ('StereoHead_0', '_ClsBranch_0', 'Conv_2'))

    def prediction_convs(self):
        return self.net.StereoHead_0.prediction_convs()

    def _net_inputs(self, image_hw, batch_size: int = 1):
        img = torch.zeros((batch_size, *image_hw, 3), device=self.device)
        return self._images(img, torch.float32), self._images(img, torch.float32)

    def int8_calib_inputs(self, batch):
        return (batch['left_images'], batch['right_images'], batch['P2'])

    def _calib_run(self, batch):
        left, right = batch[:2]
        return self.net(self._images(left, torch.float32), self._images(right, torch.float32))

    def loss(self, left_images, right_images, P2, P3, annotations, disparity=None,
             apply_fn: Optional[Callable] = None, generator: Optional[torch.Generator] = None):
        """The loss of a batch: ``(cls_loss [1], reg_loss [1], loss_dict)``,
        differentiable in the network's parameters.

        left/right_images [B, H, W, 3], P2 and P3 [B, 3, 4] (P3 is unused,
        as in the JAX package), annotations [B, M, 12], disparity
        [B, H/4, W/4] (or at a multiple of that size). The network runs in
        train mode (batch statistics; running statistics updated; the
        trunk's BatchNorms stay in eval mode under ``norm_eval``) and
        returns to eval mode after. ``apply_fn(net, left, right)`` runs the
        network (the mixed-precision policy passes its own); the
        predictions are upcast to f32 before the loss. With ``disparity``
        the stereo focal loss of the disparity volume (variance 0.5, sparse
        ground truth) joins the regression loss where the detection
        regression loss is positive (``torch.where``, no host sync).
        ``generator`` draws the class tower's dropout masks (a
        ``torch.Generator`` on the system's device, needed while
        ``self.dropout`` is on).
        """
        if not self.for_training:
            raise RuntimeError('Stereo3D.loss needs the disparity head: build the system '
                               'with training=True')
        image_hw = (left_images.shape[1], left_images.shape[2])
        cls_preds, reg_preds, depth_output = self._train_forward(
            apply_fn, generator, self._images(left_images, torch.float32),
            self._images(right_images, torch.float32))
        depth_output = depth_output.float().permute(0, 2, 3, 1)  # [B, H/4, W/4, 96]
        cls_loss, reg_loss, loss_dict = self.detection_loss(
            cls_preds.float(), reg_preds.float(), P2, annotations, image_hw)
        if disparity is not None:
            disparity = torch.as_tensor(disparity, dtype=torch.float32, device=self.device)
            disp_loss = stereo_focal_loss(depth_output, disparity, variance=0.5, sparse=True)
            disp_loss = torch.where(reg_loss.mean() > 0, disp_loss, torch.zeros_like(disp_loss))
            loss_dict['disparity_loss'] = disp_loss.reshape(1)
            reg_loss = reg_loss + disp_loss
            loss_dict['total_loss'] = cls_loss + reg_loss
        return cls_loss, reg_loss, loss_dict

    @torch.inference_mode()
    def predict_raw(self, left_images, right_images):
        """[B, H, W, 3] images -> raw (cls_preds [B, N, C+1], reg_preds
        [B, N, 12]) in the inference dtype ('int8': the int8 copy of the
        network on bf16 images, the float remainder, the correlation
        kernel among it, in bf16)."""
        net = self.inference_net()
        dtype = self.inference_dtype()
        return net(self._images(left_images, dtype), self._images(right_images, dtype))

    @torch.inference_mode()
    def predict(self, left_images, right_images, P2, P3=None, max_detections: int = 32):
        """Inference with decode + NMS on the device; fixed output shapes.

        left/right_images [B, H, W, 3], P2 [B, 3, 4]. Returns dict(scores
        [B,K], bboxes [B,K,11], labels [B,K], valid [B,K]), K = max_detections.
        """
        image_hw = (left_images.shape[1], left_images.shape[2])
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        cls_preds, reg_preds = self.predict_raw(left_images, right_images)
        return self.decode(cls_preds, reg_preds, P2, image_hw, max_detections,
                           default_nms_iou_thr=0.4)
