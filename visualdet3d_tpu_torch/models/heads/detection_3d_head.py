"""The YOLOStereo3D head, the anchor assignment and the detection loss, and
the batched decode + NMS (counterpart of ``StereoHead``, ``_ClsBranch``,
``assign_anchors``, ``detection_3d_loss``, ``get_bboxes_batched`` and
``_decode_candidates`` in ``visualdet3d_tpu/models/heads/detection_3d_head.py``).

The JAX package maps its per-image assignment and loss over the batch with
``vmap``; here the batch is a leading dimension, and each anchor's assigned
annotation row is a ``torch.gather`` (exact, as the JAX one-hot product
is). Nothing in the loss waits for the host.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.geometry import calc_iou, clip_boxes
from visualdet3d_tpu_torch.models.backbones.resnet import BasicBlock
from visualdet3d_tpu_torch.models.blocks import ChannelDropout, ConvBnReLU, anchor_flatten
from visualdet3d_tpu_torch.models.heads import target_coding
from visualdet3d_tpu_torch.models.heads.losses import (
    bce_with_logits, modified_smooth_l1, sigmoid_focal_loss)
from visualdet3d_tpu_torch.ops.nms import _greedy_suppress


# ---------------------------------------------------------------------------
# Assignment (max-IoU assigner) and the loss, over the whole batch
# ---------------------------------------------------------------------------

def assign_anchors(anchors: torch.Tensor, ann: torch.Tensor, useful: torch.Tensor,
                   fg_iou_threshold: float, bg_iou_threshold: float,
                   match_low_quality: bool = True,
                   min_iou_threshold: float = 0.0) -> Dict[str, torch.Tensor]:
    """Max-IoU assignment of every anchor of every image.

    Args:
      anchors: [N, 4]; ann: [B, M, 12] padded annotations (class -1 marks
      padding); useful: [B, N] bool geometric filter.
    Returns dict of [B, N] tensors: gt_index (the assigned row, valid only
    where pos_mask), pos_mask, neg_mask (bool) and max_iou. With
    ``match_low_quality`` each box's best anchors become positive too, the
    last box winning a tie (the reference's in-order overwrite).
    """
    gt_valid = ann[..., 4] > -0.5  # [B, M]
    iou = calc_iou(anchors, ann[..., :4])  # [B, N, M]
    iou = torch.where(gt_valid[:, None, :] & useful[:, :, None], iou, torch.full_like(iou, -1.0))

    max_iou, gt_index = iou.max(dim=2)  # the first maximum, as jnp.argmax
    neg_mask = useful & (max_iou >= 0) & (max_iou < bg_iou_threshold)
    pos_mask = useful & (max_iou >= fg_iou_threshold)

    if match_low_quality:
        gt_max = iou.max(dim=1, keepdim=True).values  # [B, 1, M]
        cond = (iou == gt_max) & gt_valid[:, None, :] & (gt_max >= min_iou_threshold) & (iou >= 0)
        any_low = cond.any(dim=2)
        m_idx = torch.arange(ann.shape[1], device=ann.device)
        low_choice = torch.where(cond, m_idx, torch.full_like(m_idx, -1)).max(dim=2).values
        gt_index = torch.where(any_low, low_choice, gt_index)
        pos_mask = pos_mask | (useful & any_low)

    return dict(gt_index=gt_index, pos_mask=pos_mask, neg_mask=neg_mask, max_iou=max_iou)


def detection_3d_loss(cls_preds: torch.Tensor,
                      reg_preds: torch.Tensor,
                      anchors: torch.Tensor,
                      anchor_mean_std: torch.Tensor,
                      useful_mask: torch.Tensor,
                      annotations: torch.Tensor,
                      num_classes: int,
                      focal_loss_gamma: float,
                      balance_weights: Union[Sequence[float], torch.Tensor],
                      regression_weight: Union[Sequence[float], torch.Tensor],
                      L1_regression_alpha: float,
                      fg_iou_threshold: float = 0.5,
                      bg_iou_threshold: float = 0.4,
                      match_low_quality: bool = True,
                      min_iou_threshold: float = 0.0):
    """Classification + regression loss of the whole batch.

    Args:
      cls_preds: [B, N, num_classes + 1] raw logits (the last one alpha's);
      reg_preds: [B, N, 12]; anchors: [N, 4]; anchor_mean_std [N, T, 6, 2];
      useful_mask: [B, N]; annotations: [B, M, 12] (class -1 padding).
    Returns (cls_loss [1], reg_loss [1], loss_dict): the classification loss
    per image over its positives and negatives, averaged over the batch;
    the 13 regression terms per image over its positives, weighted across
    images by their box counts, then averaged.
    """
    dtype, device = cls_preds.dtype, cls_preds.device
    balance_weights = torch.as_tensor(balance_weights, dtype=dtype, device=device)
    regression_weight = torch.as_tensor(regression_weight, dtype=dtype, device=device)
    b, n = cls_preds.shape[:2]
    cls_score = cls_preds[..., :num_classes]
    alpha_logit = cls_preds[..., num_classes:num_classes + 1]

    assignment = assign_anchors(anchors, annotations, useful_mask, fg_iou_threshold,
                                bg_iou_threshold, match_low_quality, min_iou_threshold)
    pos_mask, neg_mask = assignment['pos_mask'], assignment['neg_mask']
    index = assignment['gt_index'][..., None].expand(b, n, annotations.shape[-1])
    gt_rows = torch.gather(annotations, 1, index)  # [B, N, 12]
    gt_cls = gt_rows[..., 4].long()
    sel_mean_std = target_coding.select_mean_std_by_class(
        anchor_mean_std.expand(b, *anchor_mean_std.shape), gt_cls)
    pos_mask = pos_mask & (sel_mean_std[..., 0, 0] > 0)  # a z prior exists

    # classification targets: -1 ignored, 0 negative, one-hot positive
    classes = torch.arange(num_classes, device=device)
    onehot = (gt_cls[..., None] == classes).to(dtype)
    labels = torch.where(neg_mask[..., None], torch.zeros_like(onehot),
                         torch.full_like(onehot, -1.0))
    labels = torch.where(pos_mask[..., None], onehot, labels)

    num_pos = pos_mask.sum(dim=1)
    num_neg = neg_mask.sum(dim=1)
    cls_loss = sigmoid_focal_loss(cls_score, labels, focal_loss_gamma,
                                  balance_weights).sum(dim=(1, 2)) / (num_pos + num_neg).clamp(min=1)

    targets, alpha_cls = target_coding.encode(anchors, gt_rows, sel_mean_std)
    per_anchor = torch.cat([modified_smooth_l1(targets, reg_preds, L1_regression_alpha),
                            bce_with_logits(alpha_logit, alpha_cls)], dim=-1) * regression_weight
    reg_loss = torch.where(pos_mask[..., None], per_anchor,
                           torch.zeros_like(per_anchor)).sum(dim=1) / num_pos.clamp(min=1)[:, None]
    reg_loss = torch.where(num_pos[:, None] > 0, reg_loss, torch.zeros_like(reg_loss))  # [B, 13]

    num_gt = (annotations[..., 4] > -0.5).sum(dim=1)
    cls_loss = torch.where(num_gt > 0, cls_loss, torch.zeros_like(cls_loss))
    weights = num_gt.to(dtype)  # per image: its box count

    cls_loss = cls_loss.mean().reshape(1)
    weighted = (weights[:, None] * reg_loss / (weights.sum() + 1e-6)).sum(dim=0)  # [13]
    reg_loss = weighted.mean().reshape(1)
    return cls_loss, reg_loss, dict(cls_loss=cls_loss, reg_loss=reg_loss,
                                    total_loss=cls_loss + reg_loss)


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
    """Classification tower: two 3x3 convs + channel dropout (0.3) + ReLU,
    then the (zero-initialised) prediction conv. The dropout masks come
    from the generator its caller sets (``ChannelDropout``)."""

    def __init__(self, in_channels: int, num_anchors: int, num_cls_output: int,
                 cls_feature_size: int):
        super().__init__()
        self.num_cls_output = num_cls_output
        self.Conv_0 = nn.Conv2d(in_channels, cls_feature_size, 3, padding=1)
        self.Conv_1 = nn.Conv2d(cls_feature_size, cls_feature_size, 3, padding=1)
        self.Conv_2 = nn.Conv2d(cls_feature_size, num_anchors * num_cls_output, 3, padding=1)
        self.dropout = ChannelDropout(0.3)

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
