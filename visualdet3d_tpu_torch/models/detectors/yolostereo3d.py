"""YOLOStereo3D inference (counterpart of
``visualdet3d_tpu/models/detectors/yolostereo3d.py``).

Both eyes run through the trunk as one doubled batch, interleaved
(l0, r0, l1, r1, ...) as in the JAX package, so that the correlation kernel
reads each pair straight from the trunk's output. Modules take NCHW tensors
in channels_last memory format: a trunk feature permuted to NHWC is the
contiguous ``[2B, H, W, C]`` buffer the kernel takes, and the kernel's
``[B, H, W, D]`` volume permuted back is the channels_last input of the next
conv. The TPU's optimisation barriers around the eye stack have no
counterpart here.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.models.backbones.resnet import BasicBlock, resnet
from visualdet3d_tpu_torch.models.blocks import (
    ResGhostModule, bn2d, channels_last_, flax_default_init_)
from visualdet3d_tpu_torch.models.detectors.yolo3d import Yolo3DSystem
from visualdet3d_tpu_torch.models.heads.detection_3d_head import StereoHead
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
        self.BatchNorm_1 = nn.BatchNorm3d(psm_features, eps=1e-5, momentum=0.1)
        self.Conv_2 = nn.Conv3d(psm_features, psm_features, 3, padding=1)
        self.BatchNorm_2 = nn.BatchNorm3d(psm_features, eps=1e-5, momentum=0.1)

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
    """Fuse the stride-4/8/16 volumes into stride-16 features (inference
    branch; the training-time disparity head comes with the training
    slice)."""

    def __init__(self, depth_channel_4: int, depth_channel_8: int, depth_channel_16: int):
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
        self.out_channels = 3 * c16

    def forward(self, psv4, psv8, psv16):
        x = F.avg_pool2d(self.ResGhostModule_0(psv4), 2, 2)
        x = torch.cat([self.BasicBlock_0(x), psv8], dim=1)
        x = F.avg_pool2d(self.ResGhostModule_1(x), 2, 2)
        x = torch.cat([self.BasicBlock_1(x), psv16], dim=1)
        return self.BasicBlock_2(self.ResGhostModule_2(x))  # [B, 1152, H/16, W/16]


class StereoMerging(nn.Module):
    """Correlation volumes at stride 4/8 (the CUDA kernel) + the concat
    volume at 16, fused by the pyramid and concatenated after the left
    stride-16 features."""

    def __init__(self, channels_16: int):
        super().__init__()
        self.disp4, self.disp8 = 96 // 4, 192 // 8
        self.CostVolume3D_0 = CostVolume3D(channels_16, max_disp=192, downsample_scale=16,
                                           psm_features=8)
        self.CostVolumePyramid_0 = CostVolumePyramid(self.disp4, self.disp8,
                                                     self.CostVolume3D_0.out_channels)
        self.out_channels = channels_16 + self.CostVolumePyramid_0.out_channels

    def forward(self, feats):
        """``feats``: interleaved dual-eye trunk features [2B, C, H, W] at
        strides 4, 8 and 16."""
        psv4 = _nchw(correlation_volume_interleaved(_nhwc(feats[0]), self.disp4))
        psv8 = _nchw(correlation_volume_interleaved(_nhwc(feats[1]), self.disp8))
        psv16 = self.CostVolume3D_0(feats[2])
        psv_features = self.CostVolumePyramid_0(psv4, psv8, psv16)
        left16 = feats[2][0::2]
        return torch.cat([left16, psv_features], dim=1)


class YoloStereo3DNet(nn.Module):
    """Dual-eye trunk (interleaved doubled batch) + StereoMerging +
    StereoHead. Takes NCHW images, returns (cls_preds [B, N, C+1],
    reg_preds [B, N, 12])."""

    def __init__(self, backbone_cfg: dict, head_cfg: dict, num_anchors: int):
        super().__init__()
        self.ResNet_0 = resnet(**dict(backbone_cfg))
        self.StereoMerging_0 = StereoMerging(self.ResNet_0.out_channels[2])
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
        feats = self.ResNet_0(both)
        return self.StereoHead_0(self.StereoMerging_0(feats))


@DETECTOR_DICT.register_module
class Stereo3D(Yolo3DSystem):
    """The YOLOStereo3D system: the network with its weights on the system's
    device, and ``predict``."""

    # created by the JAX package's train-mode init, unused by inference
    TRAIN_ONLY_PARAMS = tuple(
        f'StereoMerging_0/CostVolumePyramid_0/{name}'
        for name in ('Conv_0', 'BatchNorm_0', 'Conv_1', 'BatchNorm_1', 'Conv_2'))

    def __init__(self, network_cfg, device: Optional[Union[str, torch.device]] = None):
        super().__init__(network_cfg, device)
        net = YoloStereo3DNet(dict(network_cfg.backbone), dict(self.layer_cfg),
                              self.anchors.num_anchors)
        flax_default_init_(net, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for conv in net.StereoHead_0.prediction_convs():
                conv.weight.zero_()
                conv.bias.zero_()
        self.net = channels_last_(net.to(self.device)).eval()

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

    def _images(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[B, H, W, 3] images -> NCHW channels_last in ``dtype`` on the device."""
        images = torch.as_tensor(images, device=self.device)
        return _nchw(images.to(dtype).contiguous())

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
