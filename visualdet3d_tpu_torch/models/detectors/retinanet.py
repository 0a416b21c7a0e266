"""RetinaNet 2D detection (counterpart of
``visualdet3d_tpu/models/detectors/retinanet.py``): a ResNet trunk, the
feature pyramid with RetinaNet's extra levels, the class and box towers
shared over the levels, the focal and IoU losses, and the decode with NMS
on the device.

The levels' predictions are concatenated into one [B, N, C] tensor in the
anchors' order (levels outer, then locations, then anchors), as in the
JAX package. Modules take NCHW tensors in channels_last memory format;
their names are the flax names, so that the weight bridge maps the flax
tree path for path. The network has no parameter-free op that the JAX
package's bf16 inference would run in f32, so ``inference_dtype =
'bfloat16'`` runs all of it on a bf16 copy; decode and NMS stay f32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.models.backbones.resnet import resnet
from visualdet3d_tpu_torch.models.blocks import anchor_flatten, channels_last_, flax_default_init_
from visualdet3d_tpu_torch.models.heads.anchors import Anchors
from visualdet3d_tpu_torch.models.heads.detection_3d_head import assign_anchors
from visualdet3d_tpu_torch.models.heads.losses import iou_loss, sigmoid_focal_loss
from visualdet3d_tpu_torch.models.quant import InferenceMixin
from visualdet3d_tpu_torch.ops.nms import nms
from visualdet3d_tpu_torch.registry import DETECTOR_DICT

CLS_PRIOR = 0.01  # the class logits' bias at init: sigmoid(bias) = CLS_PRIOR


def same_pad(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """``x`` padded with zeros as flax's 'SAME' pads a strided conv: the
    total ``max((ceil(n / s) - 1) * s + k - n, 0)`` a side pair, the odd
    one at the end (a stride-2 3x3 conv of an even size pads only the end)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: last dimension first
        total = max((math.ceil(n / stride) - 1) * stride + kernel_size - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class StridedSameConv(nn.Conv2d):
    """A stride-2 3x3 conv with flax's 'SAME' padding (:func:`same_pad`)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(same_pad(x, 3, 2))


class FPN(nn.Module):
    """The feature pyramid: 1x1 laterals (``lateral_i``), the top-down sum
    (nearest upsampling with half-pixel source indices, as
    ``jax.image.resize(..., 'nearest')``: ``'nearest-exact'``), 3x3 output
    convs (``fpn_i``), then the extra levels by stride-2 convs, the first
    on the trunk's last map (C5), the next on the level before."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.n_in = len(in_channels)
        self.num_outs = num_outs
        for i, c in enumerate(in_channels):
            self.add_module(f'lateral_{i}', nn.Conv2d(c, out_channels, 1))
            self.add_module(f'fpn_{i}', nn.Conv2d(out_channels, out_channels, 3, padding=1))
        for i in range(num_outs - self.n_in):
            c = in_channels[-1] if i == 0 else out_channels
            self.add_module(f'fpn_{self.n_in + i}', StridedSameConv(c, out_channels))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f'lateral_{i}')(feats[i]) for i in range(self.n_in)]
        for i in range(self.n_in - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:], mode='nearest-exact')
        outs = [getattr(self, f'fpn_{i}')(laterals[i]) for i in range(self.n_in)]
        if self.num_outs > self.n_in:
            outs.append(getattr(self, f'fpn_{self.n_in}')(feats[-1]))
            for i in range(self.n_in + 1, self.num_outs):
                outs.append(getattr(self, f'fpn_{i}')(outs[-1]))
        return outs


class RetinaNetNet(nn.Module):
    """ResNet + FPN + the class and box towers, one set of convs shared by
    the levels. Returns (class logits [B, N, C], box deltas [B, N, 4])."""

    def __init__(self, backbone_cfg: dict, num_classes: int, num_anchors_per_scale: int,
                 stacked_convs: int = 4, feat_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_classes, self.stacked_convs = num_classes, stacked_convs
        self.ResNet_0 = resnet(**dict(backbone_cfg))
        self.FPN_0 = FPN(self.ResNet_0.out_channels, feat_channels, num_outs)
        for i in range(stacked_convs):
            self.add_module(f'cls_conv_{i}', nn.Conv2d(feat_channels, feat_channels, 3, padding=1))
            self.add_module(f'reg_conv_{i}', nn.Conv2d(feat_channels, feat_channels, 3, padding=1))
        self.retina_cls = nn.Conv2d(feat_channels, num_anchors_per_scale * num_classes, 3,
                                    padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, num_anchors_per_scale * 4, 3, padding=1)

    @torch.no_grad()
    def reset_prediction_convs(self) -> None:
        """The flax initialisers of the two prediction convs: zero kernels,
        the class bias at the prior ``log(p / (1 - p))``, the box bias 0."""
        for conv in (self.retina_cls, self.retina_reg):
            conv.weight.zero_()
            conv.bias.zero_()
        self.retina_cls.bias.fill_(math.log(CLS_PRIOR / (1 - CLS_PRIOR)))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_scores, reg_preds = [], []
        for feat in self.FPN_0(self.ResNet_0(images)):
            cls_feat, reg_feat = feat, feat
            for i in range(self.stacked_convs):
                cls_feat = F.relu(getattr(self, f'cls_conv_{i}')(cls_feat))
                reg_feat = F.relu(getattr(self, f'reg_conv_{i}')(reg_feat))
            cls_scores.append(anchor_flatten(self.retina_cls(cls_feat), self.num_classes))
            reg_preds.append(anchor_flatten(self.retina_reg(reg_feat), 4))
        return torch.cat(cls_scores, dim=1), torch.cat(reg_preds, dim=1)


def _decode_2d(anchors: torch.Tensor, deltas: torch.Tensor, means: torch.Tensor,
               stds: torch.Tensor) -> torch.Tensor:
    """Box deltas [..., N, 4] on anchors [N, 4] -> boxes (x1, y1, x2, y2)."""
    d = deltas * stds + means
    px = 0.5 * (anchors[:, 0] + anchors[:, 2])
    py = 0.5 * (anchors[:, 1] + anchors[:, 3])
    pw = anchors[:, 2] - anchors[:, 0]
    ph = anchors[:, 3] - anchors[:, 1]
    gx = px + pw * d[..., 0]
    gy = py + ph * d[..., 1]
    gw = pw * torch.exp(d[..., 2])
    gh = ph * torch.exp(d[..., 3])
    return torch.stack([gx - gw / 2, gy - gh / 2, gx + gw / 2, gy + gh / 2], dim=-1)


def _encode_2d(anchors: torch.Tensor, gt: torch.Tensor, means: torch.Tensor,
               stds: torch.Tensor) -> torch.Tensor:
    """Boxes [..., N, 4] -> the deltas on anchors [N, 4] that decode to them
    (widths and heights clipped at 1e-6)."""
    px = 0.5 * (anchors[:, 0] + anchors[:, 2])
    py = 0.5 * (anchors[:, 1] + anchors[:, 3])
    pw = anchors[:, 2] - anchors[:, 0]
    ph = anchors[:, 3] - anchors[:, 1]
    gx = 0.5 * (gt[..., 0] + gt[..., 2])
    gy = 0.5 * (gt[..., 1] + gt[..., 3])
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=1e-6)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=1e-6)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw),
                          torch.log(gh / ph)], dim=-1)
    return (deltas - means) / stds


@DETECTOR_DICT.register_module
class RetinaNet(InferenceMixin):
    """The RetinaNet system (``configs/retinanet_2d.py``): the network with
    its weights on the system's device, ``loss``, ``predict`` and
    ``predict_raw``."""

    def __init__(self, network_cfg, device: Optional[Union[str, torch.device]] = None):
        self.cfg = network_cfg
        self.device = resolve_device(device)
        self.obj_types = list(network_cfg.obj_types)
        self.num_classes = len(self.obj_types)
        head_cfg = network_cfg.head
        anchors_cfg = dict(head_cfg.get('anchors_cfg', {}))
        anchors_cfg.pop('obj_types', None)
        self.anchors = Anchors(read_config_file=False, **anchors_cfg)
        self.loss_cfg = head_cfg.get('loss_cfg', {})
        self.test_cfg = head_cfg.get('test_cfg', {})
        self.target_means = torch.tensor(list(head_cfg.get('target_means', [0.0] * 4)),
                                         dtype=torch.float32, device=self.device)
        self.target_stds = torch.tensor(list(head_cfg.get('target_stds', [1.0] * 4)),
                                        dtype=torch.float32, device=self.device)
        neck = network_cfg.get('neck', {})
        net = RetinaNetNet(dict(network_cfg.backbone), self.num_classes,
                           len(self.anchors.ratios) * len(self.anchors.scales),
                           stacked_convs=head_cfg.get('stacked_convs', 4),
                           feat_channels=head_cfg.get('feat_channels', 256),
                           num_outs=neck.get('num_outs', 5))
        flax_default_init_(net, torch.Generator().manual_seed(0))
        net.reset_prediction_convs()
        self.net = channels_last_(net.to(self.device)).eval()
        self._anchor_cache: Dict[Tuple[int, int], torch.Tensor] = {}
        self._init_inference_cache()

    def anchor_pack(self, image_hw: Tuple[int, int]) -> torch.Tensor:
        """The anchors [N, 4] of an image shape on the system's device."""
        key = tuple(image_hw)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.as_tensor(self.anchors.anchors_for_shape(key),
                                                      device=self.device)
        return self._anchor_cache[key]

    def prediction_convs(self):
        return self.net.retina_cls, self.net.retina_reg

    def _images(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[B, H, W, 3] images -> NCHW channels_last in ``dtype`` on the device."""
        images = torch.as_tensor(images, device=self.device)
        return images.to(dtype).contiguous().permute(0, 3, 1, 2)

    def _net_inputs(self, image_hw, batch_size: int = 1):
        img = torch.zeros((batch_size, *image_hw, 3), device=self.device)
        return (self._images(img, torch.float32),)

    def loss(self, images, P2, annotations, apply_fn: Optional[Callable] = None,
             generator: Optional[torch.Generator] = None):
        """The loss of a batch: ``(cls_loss [1], reg_loss [1], loss_dict)``,
        differentiable in the network's parameters. images [B, H, W, 3],
        annotations [B, M, >= 5] (x1, y1, x2, y2, class; class -1 pads);
        P2 and ``generator`` are taken for the trainer's protocol and not
        used (the network has no dropout). The network runs in train mode
        (``apply_fn(net, images)``; the mixed-precision policy passes its
        own) and returns to eval mode; the loss is f32.

        Every anchor is matched to its best box (``assign_anchors``, no
        geometric filter); the focal loss of all classes with
        ``balance_weights`` and the IoU loss of the decoded positives are
        summed over the batch and divided by its positives plus 1e-4."""
        apply_fn = apply_fn or (lambda net, x: net(x))
        x = self._images(images, torch.float32)
        self.net.train()
        try:
            cls_scores, reg_preds = apply_fn(self.net, x)
        finally:
            self.net.eval()
        cls_scores, reg_preds = cls_scores.float(), reg_preds.float()
        ann = torch.as_tensor(annotations, dtype=torch.float32, device=self.device)
        anchors = self.anchor_pack((images.shape[1], images.shape[2]))
        b, n = cls_scores.shape[0], anchors.shape[0]
        res = assign_anchors(anchors, ann, torch.ones((b, n), dtype=torch.bool, device=self.device),
                             self.loss_cfg.get('fg_iou_threshold', 0.5),
                             self.loss_cfg.get('bg_iou_threshold', 0.4),
                             self.loss_cfg.get('match_low_quality', True))
        pos, neg = res['pos_mask'], res['neg_mask']
        gt_rows = ann.gather(1, res['gt_index'][..., None].expand(b, n, ann.shape[2]))
        labels = torch.full((b, n, self.num_classes), -1.0, device=self.device)
        labels = torch.where(neg[..., None], torch.zeros_like(labels), labels)
        onehot = F.one_hot(gt_rows[..., 4].long().clamp(0, self.num_classes - 1),
                           self.num_classes).float()
        labels = torch.where(pos[..., None], onehot, labels)

        targets = _encode_2d(anchors, gt_rows[..., :4], self.target_means, self.target_stds)
        pred_boxes = _decode_2d(anchors, reg_preds, self.target_means, self.target_stds)
        targ_boxes = _decode_2d(anchors, targets, self.target_means, self.target_stds)
        reg = torch.where(pos, iou_loss(pred_boxes, targ_boxes), torch.zeros(()).to(pred_boxes))
        balance = torch.tensor(list(self.loss_cfg.get('balance_weights',
                                                      [1.0] * self.num_classes)),
                               dtype=torch.float32, device=self.device)
        cls = sigmoid_focal_loss(cls_scores, labels, self.loss_cfg.get('gamma', 2.0), balance)
        denom = pos.sum() + 1e-4
        cls_loss = cls.sum()[None] / denom
        reg_loss = reg.sum()[None] / denom
        return cls_loss, reg_loss, dict(cls_loss=cls_loss, reg_loss=reg_loss,
                                        total_loss=cls_loss + reg_loss)

    @torch.inference_mode()
    def predict_raw(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, 3] images -> (class logits [B, N, C], box deltas [B, N,
        4]) in the inference dtype."""
        if self.cfg.get('inference_dtype', 'float32') == 'int8':
            raise NotImplementedError(
                'RetinaNet: int8 inference is not ported yet; see ROADMAP.md Queue A, A5 item 5 '
                '(the int8 surface of the mono detectors)')
        return self.inference_net()(self._images(images, self.inference_dtype()))

    @torch.inference_mode()
    def predict(self, images, P2=None, max_detections: int = 64) -> Dict[str, torch.Tensor]:
        """Inference with decode and NMS on the device; fixed output shapes.

        images [B, H, W, 3] (P2 is not used). Returns dict(scores [B, K],
        bboxes [B, K, 4], labels [B, K], valid [B, K]), K = max_detections:
        each anchor's best class above ``score_thr``, its decoded box, NMS
        over the ``nms_pre`` best candidates (class-agnostic unless the
        config's misspelt key ``cls_agnositc``, which the JAX package reads,
        says otherwise). The decode runs in f32 after a bf16 forward."""
        anchors = self.anchor_pack((images.shape[1], images.shape[2]))
        cls_scores, reg_preds = (t.float() for t in self.predict_raw(images))
        probs = torch.sigmoid(cls_scores)
        max_score, label = probs.max(dim=-1)
        boxes = _decode_2d(anchors, reg_preds, self.target_means, self.target_stds)
        valid = max_score > self.test_cfg.get('score_thr', 0.5)
        nms_boxes = boxes
        if not self.test_cfg.get('cls_agnositc', True):
            nms_boxes = boxes + label.to(boxes.dtype)[..., None] * boxes.amax(dim=(1, 2),
                                                                             keepdim=True)
        keep, keep_valid = nms(nms_boxes, max_score, self.test_cfg.get('nms_iou_thr', 0.5),
                               max_outputs=max_detections,
                               pre_top_k=min(self.test_cfg.get('nms_pre', 1000), anchors.shape[0]),
                               valid_mask=valid)
        safe = keep.clamp(min=0).long()
        return dict(scores=max_score.gather(1, safe) * keep_valid,
                    bboxes=boxes.gather(1, safe[..., None].expand(*safe.shape, 4)),
                    labels=label.gather(1, safe), valid=keep_valid)
