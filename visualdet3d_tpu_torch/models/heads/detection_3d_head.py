"""The YOLOStereo3D head and the batched decode + NMS (counterpart of
``StereoHead``, ``_ClsBranch``, ``get_bboxes_batched`` and
``_decode_candidates`` in ``visualdet3d_tpu/models/heads/detection_3d_head.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.geometry import calc_iou, clip_boxes
from visualdet3d_tpu_torch.models.backbones.resnet import BasicBlock
from visualdet3d_tpu_torch.models.blocks import ConvBnReLU, anchor_flatten
from visualdet3d_tpu_torch.models.heads import target_coding
from visualdet3d_tpu_torch.ops.nms import _greedy_suppress


def _decode_candidates(top_scores, cand_valid, cand_anchors, cand_reg, cand_alpha,
                       cand_label, cand_mean_std, image_hw, nms_iou_thr,
                       max_detections, cls_agnostic):
    """Decode + NMS tail on K score-sorted candidates per image, batched
    over the leading dimension B."""
    bsz, k = top_scores.shape
    sel_mean_std = target_coding.select_mean_std_by_class(cand_mean_std, cand_label)
    boxes, prior_ok = target_coding.decode(cand_anchors, cand_reg, sel_mean_std, cand_alpha)
    cand_valid = cand_valid & prior_ok
    boxes = clip_boxes(boxes, image_hw)

    nms_boxes = boxes[..., :4]
    if not cls_agnostic:
        max_coord = nms_boxes.amax(dim=(-2, -1), keepdim=True)  # per image
        nms_boxes = nms_boxes + cand_label.to(nms_boxes.dtype)[..., None] * max_coord

    iou = calc_iou(nms_boxes, nms_boxes)
    keep = _greedy_suppress(iou, cand_valid, nms_iou_thr)
    ranks = torch.arange(k, device=keep.device).expand(bsz, k)
    kept_rank = torch.where(keep, ranks, torch.full_like(ranks, k))
    # survivors in score order; a stable sort breaks the padding ties by
    # lowest index, as the JAX top_k of the negated rank does
    m = min(max_detections, k)
    sel = torch.sort(kept_rank, dim=1, stable=True).indices[:, :m]
    keep_valid = torch.gather(keep, 1, sel)
    if m < max_detections:  # tiny-anchor configs (pre_top_k < max_detections)
        sel = F.pad(sel, (0, max_detections - m))
        keep_valid = F.pad(keep_valid, (0, max_detections - m))
    scores = torch.gather(top_scores, 1, sel) * keep_valid
    out_boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, boxes.shape[-1]))
    labels = torch.gather(cand_label, 1, sel)
    return scores, out_boxes, labels, keep_valid


def get_bboxes_batched(cls_preds: torch.Tensor,
                       reg_preds: torch.Tensor,
                       num_anchors: int,
                       anchors: torch.Tensor,
                       anchor_mean_std: torch.Tensor,
                       useful_mask: torch.Tensor,
                       num_classes: int,
                       image_hw: Tuple[int, int],
                       score_thr: float = 0.75,
                       nms_iou_thr: float = 0.5,
                       max_detections: int = 32,
                       pre_top_k: int = 1024,
                       cls_agnostic: bool = True):
    """Batched decode with top-K candidate selection, all on the device.

    Args: cls_preds [B, N, C+1] raw logits, reg_preds [B, N, R], anchors
    [N, 4], anchor_mean_std [N, T, 6, 2], useful_mask [B, N] bool,
    num_anchors = anchors per location (N = HW * num_anchors, locations
    outer / anchors inner). Logits may be bf16: scores are thresholded at
    the logits' precision and cast to f32 only on the K candidates.
    Returns (scores [B,K], bboxes [B,K,11], labels [B,K], valid [B,K]),
    K = max_detections.
    """
    B, N, C = cls_preds.shape
    A = num_anchors
    HW = N // A
    if HW * A != N:
        raise ValueError(f'{N} predictions are not a multiple of {A} anchors')
    R = reg_preds.shape[-1]

    # class c of anchor a lives at channel a*C + c
    cls_hw = cls_preds.reshape(B, HW, A * C)
    best = torch.sigmoid(cls_hw[:, :, 0::C])
    label = torch.zeros(best.shape, dtype=torch.int64, device=best.device)
    for c in range(1, num_classes):
        s = torch.sigmoid(cls_hw[:, :, c::C])
        better = s > best  # strict: ties keep the FIRST max, like argmax
        label = torch.where(better, torch.full_like(label, c), label)
        best = torch.maximum(best, s)
    alpha = torch.sigmoid(cls_hw[:, :, num_classes::C])

    max_score = best.reshape(B, N)
    label = label.reshape(B, N)
    alpha = alpha.reshape(B, N)
    valid = useful_mask & (max_score > score_thr)

    k = min(pre_top_k, N)
    neg_inf = torch.finfo(max_score.dtype).min
    masked = torch.where(valid, max_score, torch.full_like(max_score, neg_inf))
    top_scores, order = torch.topk(masked, k, dim=1, largest=True, sorted=True)
    cand_valid = top_scores > neg_inf

    loc = order // A
    a_idx = order % A
    rows = torch.gather(reg_preds.reshape(B, HW, A * R), 1,
                        loc[..., None].expand(B, k, A * R))
    cand_reg = torch.gather(rows.reshape(B, k, A, R), 2,
                            a_idx[..., None, None].expand(B, k, 1, R)).squeeze(2).float()
    cand_alpha = torch.gather(alpha, 1, order)[..., None].float()
    cand_label = torch.gather(label, 1, order)
    cand_anchors = anchors[order]            # [B, K, 4]
    cand_mean_std = anchor_mean_std[order]   # [B, K, T, 6, 2]
    return _decode_candidates(top_scores.float(), cand_valid, cand_anchors, cand_reg,
                              cand_alpha, cand_label, cand_mean_std, image_hw,
                              nms_iou_thr, max_detections, cls_agnostic)


class _ClsBranch(nn.Module):
    """Classification tower: two 3x3 convs + Dropout2d(0.3) + ReLU, then the
    (zero-initialised) prediction conv."""

    def __init__(self, in_channels: int, num_anchors: int, num_cls_output: int,
                 cls_feature_size: int):
        super().__init__()
        self.num_cls_output = num_cls_output
        self.Conv_0 = nn.Conv2d(in_channels, cls_feature_size, 3, padding=1)
        self.Conv_1 = nn.Conv2d(cls_feature_size, cls_feature_size, 3, padding=1)
        self.Conv_2 = nn.Conv2d(cls_feature_size, num_anchors * num_cls_output, 3, padding=1)
        self.dropout = nn.Dropout2d(0.3)

    def forward(self, x):
        for conv in (self.Conv_0, self.Conv_1):
            x = F.relu(self.dropout(conv(x)))
        return anchor_flatten(self.Conv_2(x), self.num_cls_output)


class StereoHead(nn.Module):
    """YOLOStereo3D head: the class tower, and a 1408-channel
    ConvBnReLU + BasicBlock regression tower."""

    def __init__(self, in_channels: int, num_anchors: int, num_cls_output: int,
                 num_reg_output: int = 12, cls_feature_size: int = 256,
                 reg_feature_size: int = 1408):
        super().__init__()
        self.num_reg_output = num_reg_output
        self._ClsBranch_0 = _ClsBranch(in_channels, num_anchors, num_cls_output,
                                       cls_feature_size)
        self.ConvBnReLU_0 = ConvBnReLU(in_channels, reg_feature_size, (3, 3))
        self.BasicBlock_0 = BasicBlock(reg_feature_size, reg_feature_size)
        self.Conv_0 = nn.Conv2d(reg_feature_size, num_anchors * num_reg_output, 3, padding=1)

    def prediction_convs(self):
        """The two zero-initialised output convs: (class, regression)."""
        return self._ClsBranch_0.Conv_2, self.Conv_0

    def forward(self, features):
        cls = self._ClsBranch_0(features)
        x = F.relu(self.BasicBlock_0(self.ConvBnReLU_0(features)))
        reg = anchor_flatten(self.Conv_0(x), self.num_reg_output)
        return cls, reg
