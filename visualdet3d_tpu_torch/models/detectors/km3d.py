"""KM3D and MonoFlex (counterpart of ``visualdet3d_tpu/models/detectors/km3d.py``):
center-based monocular 3D detection, the DLA trunk with the deformable
upsampling neck to stride 4 (16 DCNs, the CUDA kernels on the card, forward
and backward), the per-branch head towers, the training loss
(``KM3D.loss``) and the heatmap decode with NMS on the device. ``MonoFlex``
is the same network with its own head branches, loss and decode.

Modules take NCHW tensors in channels_last memory format; the head's maps
go to the loss and the decode as NHWC views, the JAX package's layout.
The ``resnet`` core comes with a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.models.backbones.dla import dlanet
from visualdet3d_tpu_torch.models.backbones.dla_utils import DLASegUpsample
from visualdet3d_tpu_torch.models.blocks import channels_last_, flax_default_init_
from visualdet3d_tpu_torch.models.heads import km3d_head as km3d_lib
from visualdet3d_tpu_torch.models.heads import monoflex_head as monoflex_lib
from visualdet3d_tpu_torch.models.quant import InferenceMixin
from visualdet3d_tpu_torch.registry import DETECTOR_DICT


class KM3DCore(nn.Module):
    """Backbone + upsampling to stride 4."""

    def __init__(self, backbone_cfg: dict):
        super().__init__()
        cfg = dict(backbone_cfg)
        name = cfg.pop('name', 'dla').lower()
        if name == 'resnet':
            raise NotImplementedError(
                "KM3DCore: the 'resnet' core (bilinear up + conv chain) is not ported "
                'yet; see ROADMAP.md Queue A, A3 item 1 (the KM3D resnet core)')
        if name != 'dla':
            raise NotImplementedError(name)
        self.DLA_0 = dlanet(**cfg)
        self.DLASegUpsample_0 = DLASegUpsample(
            input_channels=(16, 32, 64, 128, 256, 512), down_ratio=4, last_level=5,
            out_channel=64)
        self.out_channels = self.DLASegUpsample_0.out_channels

    def forward(self, images):
        return self.DLASegUpsample_0(self.DLA_0(images))


class KM3DNet(nn.Module):
    def __init__(self, backbone_cfg: dict, head_dict, head_features: int = 64):
        super().__init__()
        self.KM3DCore_0 = KM3DCore(backbone_cfg)
        self.KM3DHeadNet_0 = km3d_lib.KM3DHeadNet(self.KM3DCore_0.out_channels, head_dict,
                                                  head_features)

    def forward(self, images) -> Dict[str, torch.Tensor]:
        return self.KM3DHeadNet_0(self.KM3DCore_0(images))


@DETECTOR_DICT.register_module
class KM3D(InferenceMixin):
    """The KM3D system: the network with its weights on the system's device,
    ``predict`` and ``predict_raw``."""

    decode_fn = staticmethod(km3d_lib.km3d_decode)
    default_head_dict = km3d_lib.DEFAULT_HEAD_DICT

    def __init__(self, network_cfg, device: Optional[Union[str, torch.device]] = None):
        self.cfg = network_cfg
        self.device = resolve_device(device)
        self.obj_types = list(network_cfg.obj_types)
        head_cfg = network_cfg.head
        layer_cfg = dict(head_cfg.get('layer_cfg', {}))
        head_dict = dict(layer_cfg.get('head_dict', self.default_head_dict))
        head_dict['hm'] = len(self.obj_types)
        self.head_dict = tuple(sorted(head_dict.items()))
        self.loss_cfg = head_cfg.get('loss_cfg', {})
        self.test_cfg = head_cfg.get('test_cfg', {})
        net = KM3DNet(dict(network_cfg.backbone), self.head_dict,
                      layer_cfg.get('head_features', 64))
        generator = torch.Generator().manual_seed(0)
        flax_default_init_(net, generator)
        net.KM3DHeadNet_0.reset_out_convs(generator)
        self.net = channels_last_(net.to(self.device)).eval()
        self._init_inference_cache()

    def loss(self, images, gts, P2, epoch: float = 100.0,
             apply_fn: Optional[Callable] = None):
        """The loss of a batch: ``(loss, loss_dict)``, differentiable in
        the network's parameters. images [B, H, W, 3], gts the target
        builder's arrays stacked over the batch, P2 [B, 3, 4]; ``epoch``
        feeds the rampup weight of the position terms. The network runs in
        train mode (batch statistics, running statistics updated) and
        returns to eval mode after, so ``predict`` keeps the running
        statistics. ``apply_fn(net, images)`` runs the
        network (the mixed-precision policy passes its own); the head's maps
        are upcast to f32 before the loss."""
        apply_fn = apply_fn or (lambda net, x: net(x))
        x = self._images(images, torch.float32)
        self.net.train()
        try:
            output = apply_fn(self.net, x)
        finally:
            self.net.eval()
        output = {k: v.float().permute(0, 2, 3, 1) for k, v in output.items()}
        gts = {k: torch.as_tensor(v, device=self.device) for k, v in gts.items()}
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        return self._loss_terms(output, gts, P2, epoch, images.shape[2] // 4)

    def _loss_terms(self, output, gts, P2, epoch, output_w: int):
        """The KM3D loss of the head's NHWC f32 maps."""
        return km3d_lib.km3d_loss(output, gts, P2, epoch, output_w,
                                  rampup_length=self.loss_cfg.get('rampup_length', 100))

    def _images(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[B, H, W, 3] images -> NCHW channels_last in ``dtype`` on the device."""
        images = torch.as_tensor(images, device=self.device)
        return images.to(dtype).contiguous().permute(0, 3, 1, 2)

    @torch.inference_mode()
    def predict_raw(self, images) -> Dict[str, torch.Tensor]:
        """[B, H, W, 3] images -> the head's maps, NHWC [B, H/4, W/4, C], in
        the inference dtype."""
        out = self.inference_net()(self._images(images, self.inference_dtype()))
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}

    @torch.inference_mode()
    def predict(self, images, P2, max_detections: int = 32) -> Dict[str, torch.Tensor]:
        """Inference with decode + NMS on the device; fixed output shapes.

        images [B, H, W, 3], P2 [B, 3, 4] at input scale. Returns
        dict(scores [B,K], bboxes [B,K,11], labels [B,K], valid [B,K]),
        K = max_detections. The decode runs in f32 after a bf16 forward.
        """
        image_hw = (images.shape[1], images.shape[2])
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        output = {k: v.float() for k, v in self.predict_raw(images).items()}
        return self.decode_fn(
            output, P2, image_hw,
            score_thr=self.test_cfg.get('score_thr', 0.1),
            nms_iou_thr=self.test_cfg.get('nms_iou_thr', 0.5),
            top_k=self.test_cfg.get('top_k', 100),
            max_detections=max_detections,
            # the reference reads the misspelt key, so its NMS is class-agnostic
            cls_agnostic=self.test_cfg.get('cls_agnositc', True))


@DETECTOR_DICT.register_module
class MonoFlex(KM3D):
    """The MonoFlex system: KM3D's network and ``predict`` with MonoFlex's
    head branches, decode and loss (``loss_cfg`` keys
    ``uncertainty_range`` and ``uncertainty_weight``)."""

    decode_fn = staticmethod(monoflex_lib.monoflex_decode)
    default_head_dict = monoflex_lib.MONOFLEX_HEAD_DICT

    def _loss_terms(self, output, gts, P2, epoch, output_w: int):
        return monoflex_lib.monoflex_loss(
            output, gts, P2, epoch,
            uncertainty_range=tuple(self.loss_cfg.get('uncertainty_range', (-10.0, 10.0))),
            uncertainty_weight=self.loss_cfg.get('uncertainty_weight', 1.0))
