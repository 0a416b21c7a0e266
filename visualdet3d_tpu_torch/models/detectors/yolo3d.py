"""GAC monocular 3D detection and the anchor-based detector system base
(counterpart of ``visualdet3d_tpu/models/detectors/yolo3d.py``).

A system holds the network (an ``nn.Module`` with its weights, on the
system's device), the anchors and their priors, the detection loss, and the
decode + NMS that turns raw predictions into a fixed number of detections
per image. ``Yolo3DSystem`` carries what the stereo system shares with the
monocular ones: ``Yolo3D`` (a ResNet trunk at stride 16 and the DCN-headed
``AnchorBasedDetection3DHead``) and ``GroundAwareYolo3D`` (the same trunk
and GAC's ``GroundAwareHead``, whose ``LookGround`` samples features toward
the ground plane). Modules take NCHW tensors in channels_last memory format.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.models.backbones.resnet import resnet
from visualdet3d_tpu_torch.models.blocks import ChannelDropout, channels_last_, flax_default_init_
from visualdet3d_tpu_torch.models.heads import detection_3d_head as head_lib
from visualdet3d_tpu_torch.models.heads.anchors import Anchors
from visualdet3d_tpu_torch.models.quant import InferenceMixin
from visualdet3d_tpu_torch.registry import DETECTOR_DICT


class Yolo3DSystem(InferenceMixin):
    """Config-built detector system.

    ``cfg.inference_dtype = 'bfloat16'`` runs the network in bf16 (decode
    and NMS stay f32, the logits stay bf16 until the top-K gather), as the
    JAX package's ``_inference_cast`` does; ``'int8'`` runs the int8 copy of
    the folded network (``models/quant.py``: ``fold_inference_variables``,
    ``calibrate_int8``, ``quantize_int8``) with a bf16 remainder.
    """

    def __init__(self, network_cfg, device: Optional[Union[str, torch.device]] = None):
        self.cfg = network_cfg
        self.device = resolve_device(device)
        self.obj_types = list(network_cfg.obj_types)
        self.num_classes = len(self.obj_types)

        head_cfg = network_cfg.head
        anchors_cfg = dict(head_cfg.anchors_cfg)
        anchors_cfg.pop('obj_types', None)
        self.anchors = Anchors(
            preprocessed_path=head_cfg.get('preprocessed_path', ''),
            obj_types=self.obj_types,
            read_config_file=head_cfg.get('read_precompute_anchor', True),
            **anchors_cfg)
        self.loss_cfg = head_cfg.loss_cfg
        self.test_cfg = head_cfg.test_cfg
        self.layer_cfg = head_cfg.layer_cfg
        self.num_regression_loss_terms = head_cfg.get('num_regression_loss_terms', 13)

        self._anchor_cache: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._init_inference_cache()

    # -------------------------------------------------------------- helpers
    def anchor_pack(self, image_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """The anchors of an image shape as tensors on the system's device."""
        key = tuple(image_hw)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = {
                k: torch.as_tensor(v, device=self.device)
                for k, v in self.anchors.get(key).items()}
        return self._anchor_cache[key]

    def _images(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[B, H, W, 3] images -> NCHW channels_last in ``dtype`` on the device."""
        images = torch.as_tensor(images, device=self.device)
        return images.to(dtype).contiguous().permute(0, 3, 1, 2)

    def _train_forward(self, apply_fn: Optional[Callable], generator: Optional[torch.Generator],
                       *inputs, **kwargs):
        """The network in train mode on ``inputs`` (``apply_fn(net, *inputs,
        **kwargs)``, the plain call by default: the mixed-precision policy
        passes its own, which casts the positional inputs), the class
        tower's dropout masks drawn from ``generator`` while
        ``self.dropout`` is on; back in eval mode after."""
        if self.dropout and generator is None:
            raise ValueError(f'{type(self).__name__}.loss: the class tower\'s dropout needs a '
                             'generator (or set system.dropout = False)')
        apply_fn = apply_fn or (lambda net, *x, **kw: net(*x, **kw))
        dropouts = [m for m in self.net.modules() if isinstance(m, ChannelDropout)]
        for m in dropouts:
            m.generator = generator if self.dropout else None
        self.net.train()
        try:
            return apply_fn(self.net, *inputs, **kwargs)
        finally:
            self.net.eval()
            for m in dropouts:
                m.generator = None

    def detection_loss(self, cls_preds, reg_preds, P2, annotations, image_hw):
        """``detection_3d_loss`` of f32 predictions against ``annotations``
        [B, M, 12], the anchors filtered by P2 [B, 3, 4] unless the config
        says otherwise: ``(cls_loss [1], reg_loss [1], loss_dict)``."""
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        annotations = torch.as_tensor(annotations, dtype=torch.float32, device=self.device)
        pack = self.anchor_pack(image_hw)
        if self.loss_cfg.get('filter_anchor', True):
            useful = self.anchors.useful_mask(pack, P2)
        else:
            useful = torch.ones((P2.shape[0], pack['anchors'].shape[0]), dtype=torch.bool,
                                device=self.device)
        return head_lib.detection_3d_loss(
            cls_preds, reg_preds, pack['anchors'], pack['anchor_mean_std'], useful, annotations,
            num_classes=self.num_classes,
            focal_loss_gamma=self.loss_cfg.get('focal_loss_gamma', 0.0),
            balance_weights=self.loss_cfg.get('balance_weight', [1.0] * self.num_classes),
            regression_weight=self.loss_cfg.get(
                'regression_weight', [1.0] * self.num_regression_loss_terms),
            L1_regression_alpha=self.loss_cfg.get('L1_regression_alpha', 25.0),
            fg_iou_threshold=self.loss_cfg.get('fg_iou_threshold', 0.5),
            bg_iou_threshold=self.loss_cfg.get('bg_iou_threshold', 0.4),
            match_low_quality=self.loss_cfg.get('match_low_quality', True))

    def decode(self, cls_preds, reg_preds, P2, image_hw, max_detections: int = 32,
               default_nms_iou_thr: float = 0.5):
        """Raw predictions -> dict(scores [B,K], bboxes [B,K,11], labels
        [B,K], valid [B,K]), K = max_detections."""
        pack = self.anchor_pack(image_hw)
        is_filtering = self.test_cfg.get(
            'filter_anchor', self.loss_cfg.get('filter_anchor', True))
        if is_filtering:
            useful = self.anchors.useful_mask(pack, P2)
        else:
            useful = torch.ones((P2.shape[0], pack['anchors'].shape[0]),
                                dtype=torch.bool, device=P2.device)
        scores, bboxes, labels, valid = head_lib.get_bboxes_batched(
            cls_preds, reg_preds, self.anchors.num_anchors,
            pack['anchors'], pack['anchor_mean_std'], useful,
            num_classes=self.num_classes,
            image_hw=image_hw,
            score_thr=self.test_cfg.get('score_thr', 0.75),
            nms_iou_thr=self.test_cfg.get('nms_iou_thr', default_nms_iou_thr),
            max_detections=max_detections,
            # the reference reads the misspelt key, so its NMS is class-agnostic
            cls_agnostic=self.test_cfg.get('cls_agnositc', True),
        )
        return dict(scores=scores, bboxes=bboxes, labels=labels, valid=valid)


class Yolo3DNet(nn.Module):
    """ResNet trunk (one stride-16 level) + the anchor head: GAC's
    ``GroundAwareHead`` or Yolo3D's ``AnchorBasedDetection3DHead``, under
    its flax name. Takes NCHW images and P2 [B, 3, 4]; returns (cls_preds
    [B, N, C+1], reg_preds [B, N, 12])."""

    def __init__(self, backbone_cfg: dict, head_cfg: dict, num_anchors: int,
                 ground_aware: bool = False):
        super().__init__()
        self.ResNet_0 = resnet(**dict(backbone_cfg))
        head_cls = head_lib.GroundAwareHead if ground_aware else \
            head_lib.AnchorBasedDetection3DHead
        self.head_name = f'{head_cls.__name__}_0'
        self.add_module(self.head_name, head_cls(
            self.ResNet_0.out_channels[0],
            num_anchors=num_anchors,
            num_cls_output=head_cfg['num_cls_output'],
            num_reg_output=head_cfg['num_reg_output'],
            cls_feature_size=head_cfg.get('cls_feature_size', 512),
            reg_feature_size=head_cfg.get('reg_feature_size', 1024)))

    @property
    def head(self) -> nn.Module:
        return getattr(self, self.head_name)

    def forward(self, images, P2):
        return self.head(self.ResNet_0(images)[0], P2)


@DETECTOR_DICT.register_module
class Yolo3D(Yolo3DSystem):
    """The monocular anchor detector with the DCN-headed head: the network
    with its weights on the system's device, ``loss`` and ``predict``.
    ``dropout`` switches the class tower's channel dropout in training (on
    by default; its masks come from the generator ``loss`` is given)."""

    ground_aware = False

    # the prediction convs stay in floats unless cfg.int8_all. For Yolo3D's
    # regression output the JAX package names ('AnchorBasedDetection3DHead_0',
    # 'Conv_2'), which does not exist (flax numbers the Conv_* apart from
    # ModulatedDeformConv_0), so JAX quantizes that conv; the port keeps
    # Conv_1, the conv meant, in floats
    int8_deny = (
        ('GroundAwareHead_0', 'Conv_2'),
        ('GroundAwareHead_0', '_ClsBranch_0', 'Conv_2'),
        ('AnchorBasedDetection3DHead_0', 'Conv_1'),
        ('AnchorBasedDetection3DHead_0', '_ClsBranch_0', 'Conv_2'),
    )

    def __init__(self, network_cfg, device: Optional[Union[str, torch.device]] = None):
        super().__init__(network_cfg, device)
        self.dropout = True
        net = Yolo3DNet(dict(network_cfg.backbone), dict(self.layer_cfg),
                        self.anchors.num_anchors, ground_aware=self.ground_aware)
        flax_default_init_(net, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for conv in net.head.prediction_convs():
                conv.weight.zero_()
                conv.bias.zero_()
        self.net = channels_last_(net.to(self.device)).eval()

    def prediction_convs(self):
        return self.net.head.prediction_convs()

    def _net_inputs(self, image_hw, batch_size: int = 1):
        img = torch.zeros((batch_size, *image_hw, 3), device=self.device)
        P2 = torch.eye(3, 4, device=self.device).expand(batch_size, 3, 4)
        return self._images(img, torch.float32), P2

    def int8_calib_inputs(self, batch):
        return (batch['images'], batch['P2'])

    def _calib_run(self, batch):
        images, P2 = batch[:2]
        return self.net(self._images(images, torch.float32),
                        torch.as_tensor(P2, dtype=torch.float32, device=self.device))

    def loss(self, images, P2, annotations, apply_fn: Optional[Callable] = None,
             generator: Optional[torch.Generator] = None):
        """The loss of a batch: ``(cls_loss [1], reg_loss [1], loss_dict)``,
        differentiable in the network's parameters.

        images [B, H, W, 3], P2 [B, 3, 4], annotations [B, M, 12]. The
        network runs in train mode (batch statistics; running statistics
        updated) and returns to eval mode after. ``apply_fn(net, images,
        P2=P2)`` runs it (the mixed-precision policy passes its own, which
        casts the images, not P2, as the JAX policy casts only conv inputs);
        the predictions are upcast to f32 before the loss. ``generator``
        draws the class tower's dropout masks (a ``torch.Generator`` on the
        system's device, needed while ``self.dropout`` is on).
        """
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        cls_preds, reg_preds = self._train_forward(
            apply_fn, generator, self._images(images, torch.float32), P2=P2)
        return self.detection_loss(cls_preds.float(), reg_preds.float(), P2, annotations,
                                   (images.shape[1], images.shape[2]))

    @torch.inference_mode()
    def predict_raw(self, images, P2):
        """[B, H, W, 3] images, P2 [B, 3, 4] -> raw (cls_preds [B, N, C+1],
        reg_preds [B, N, 12]). In bf16 the images and weights are bf16 and
        P2 stays f32, as in the JAX package; GAC's regression output is
        then f32 (``GroundAwareHead``). In int8 the quantized convs return
        bf16, as the JAX package's do, so GAC's tower is bf16 from its
        first quantized conv on, its regression output too."""
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        return self.inference_net()(self._images(images, self.inference_dtype()), P2)

    @torch.inference_mode()
    def predict(self, images, P2, max_detections: int = 32):
        """Inference with decode + NMS on the device; fixed output shapes.

        images [B, H, W, 3], P2 [B, 3, 4]. Returns dict(scores [B,K], bboxes
        [B,K,11], labels [B,K], valid [B,K]), K = max_detections.
        """
        image_hw = (images.shape[1], images.shape[2])
        P2 = torch.as_tensor(P2, dtype=torch.float32, device=self.device)
        cls_preds, reg_preds = self.predict_raw(images, P2)
        return self.decode(cls_preds, reg_preds, P2, image_hw, max_detections)


@DETECTOR_DICT.register_module
class GroundAwareYolo3D(Yolo3D):
    """GAC (``configs/yolo3d_gac.py``): ``Yolo3D`` with the ground-aware
    head."""

    ground_aware = True
