"""MonoFlex head (counterpart of ``visualdet3d_tpu/models/heads/monoflex_head.py``):
KM3D's head towers with an FCOS-style 2D box, the direct depth exp(-x),
keypoint-pair depths and their uncertainty-weighted fusion; the loss and
the decode.

The JAX package decodes one image at a time and ``vmap``s the decoder over
the batch; here the decode is written for a batch, with every op
per-image, so that a batched decode equals the per-image one.
"""
from __future__ import annotations

from typing import Dict

import torch

from visualdet3d_tpu_torch.geometry import clip_boxes
from visualdet3d_tpu_torch.models.heads import rtm3d_utils as rtm
from visualdet3d_tpu_torch.models.heads.km3d_head import neg_loss, reg_weighted_l1_loss
from visualdet3d_tpu_torch.models.heads.losses import iou_loss
from visualdet3d_tpu_torch.ops.nms import nms
from visualdet3d_tpu_torch.parallel.mesh import all_sum

# branch name -> output channels (configs/monoflex.py)
MONOFLEX_HEAD_DICT = {'hm': 3, 'bbox2d': 4, 'hps': 20, 'rot': 8, 'dim': 3,
                      'depth': 1, 'depth_uncertainty': 1,
                      'corner_uncertainty': 3, 'reg': 2}

LOSS_WEIGHTS = {'hm_loss': 1, 'hp_loss': 1, 'box2d_loss': 1, 'off_loss': 0.5,
                'dim_loss': 1, 'depth_loss': 1, 'kpd_loss': 0.2, 'rot_loss': 1.0,
                'soft_depth_loss': 0.2}


def _gather_all(output: Dict[str, torch.Tensor], ind: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every regression branch at the flat indices ``ind`` [B, K]."""
    def g(k):
        return rtm.transpose_and_gather_feat(output[k], ind)
    hps = g('hps')
    b, k, _ = hps.shape
    return dict(
        bbox2d=g('bbox2d'), dim=g('dim'), rot=g('rot'),
        hps=hps.reshape(b, k, -1, 2), offset=g('reg'), depth=g('depth'),
        depth_uncer=g('depth_uncertainty'), corner_uncer=g('corner_uncertainty'))


def merge_depth(depth: torch.Tensor, depth_uncer: torch.Tensor) -> torch.Tensor:
    """Inverse-uncertainty weighted fusion over the last axis."""
    w = 1.0 / depth_uncer
    w = w / w.sum(dim=-1, keepdim=True)
    return (depth * w).sum(dim=-1)


def _decode_fcos_bbox(reg_preds: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(l, t, r, b) distances from ``points`` (x, y) -> (x1, y1, x2, y2)."""
    xs, ys = points[..., 0], points[..., 1]
    return torch.stack([xs - reg_preds[..., 0], ys - reg_preds[..., 1],
                        xs + reg_preds[..., 2], ys + reg_preds[..., 3]], dim=-1)


def _fused_depth(g: Dict[str, torch.Tensor], P2: torch.Tensor, uncertainty_range):
    """(direct depth [.., 1], keypoint depths [.., 3], clamped direct and
    keypoint uncertainties, the merged depth [..]) of gathered predictions;
    P2 [B, 3, 4]."""
    depth_decoded = rtm.decode_depth_inv_sigmoid(g['depth'])
    calib = P2[:, None].expand(-1, g['dim'].shape[1], -1, -1)
    kpd_depth = rtm.decode_depth_from_keypoints(g['hps'], g['dim'], calib)
    depth_uncer = g['depth_uncer'].clamp(*uncertainty_range)
    corner_uncer = g['corner_uncer'].clamp(*uncertainty_range)
    combined_uncer = torch.exp(torch.cat([depth_uncer, corner_uncer], -1))
    merged = merge_depth(torch.cat([depth_decoded, kpd_depth], -1), combined_uncer)
    return depth_decoded, kpd_depth, depth_uncer, corner_uncer, merged


def monoflex_loss(output: Dict[str, torch.Tensor], ann: Dict[str, torch.Tensor],
                  P2: torch.Tensor, epoch=None, uncertainty_range=(-10.0, 10.0),
                  uncertainty_weight: float = 1.0):
    """The full MonoFlex loss: (total, the per-term dict with
    ``total_loss``). output: NHWC f32 maps; ann: the MonoFlex target
    builder's tensors; P2 [B, 3, 4]. Every term divides by the number of
    positive objects. ``epoch`` is unused (the signature of ``km3d_loss``)."""
    ind = ann['ind'].long()
    mask = ann['reg_mask'].float()  # [B, M]
    n_pos = all_sum(mask.sum())

    hm_loss = neg_loss(output['hm'], ann['hm'])
    hp_loss = reg_weighted_l1_loss(output['hps'], ann['hps_mask'], ind, ann['hps'], ann['dep'])
    rot_pred = rtm.transpose_and_gather_feat(output['rot'], ind)
    rot_loss = rtm.compute_rot_loss(rot_pred, ann['rotbin'], ann['rotres'],
                                    ann['reg_mask'][..., None])

    g = _gather_all(output, ind)
    depth_decoded, kpd_depth, depth_uncer, corner_uncer, merged = _fused_depth(
        g, P2, uncertainty_range)

    m1 = mask[..., None]
    # the FCOS IoU loss on boxes (-l, -t, r, b) about the center
    pred_box = torch.cat([-g['bbox2d'][..., :2], g['bbox2d'][..., 2:]], -1)
    targ = ann['bboxes2d_target']
    targ_box = torch.cat([-targ[..., :2], targ[..., 2:]], -1)
    box2d_loss = all_sum((iou_loss(pred_box, targ_box) * mask).sum()) / (n_pos + 1e-4)

    dim_loss = all_sum(((g['dim'] - ann['dim']).abs() * m1).sum()) / (n_pos + 1e-4)
    off_loss = all_sum(((g['offset'] - ann['reg']).abs() * m1).sum()) / (n_pos + 1e-4)

    depth_loss = ((depth_decoded - ann['dep']).abs() * torch.exp(-depth_uncer)
                  + depth_uncer * uncertainty_weight)
    depth_loss = all_sum((depth_loss * m1).sum()) / (n_pos + 1e-4)

    kp_target = ann['dep'].repeat_interleave(3, dim=-1)
    kp_mask = ann['kp_detph_mask'].float()
    kp_loss_raw = ((kpd_depth - kp_target).abs() * torch.exp(-corner_uncer)
                   + corner_uncer * uncertainty_weight)
    # invalid keypoint depths count in the value, not in the gradient
    kp_valid = kp_loss_raw * kp_mask + (1 - kp_mask) * kp_loss_raw.detach()
    keypoint_depth_loss = all_sum((kp_valid.mean(dim=-1) * mask).sum()) / (n_pos + 1e-4)

    soft_depth_loss = all_sum(((merged[..., None] - ann['dep']).abs() * m1).sum()) / (n_pos + 1e-4)

    loss_stats = {'hm_loss': hm_loss, 'hp_loss': hp_loss,
                  'box2d_loss': box2d_loss, 'off_loss': off_loss,
                  'dim_loss': dim_loss, 'depth_loss': depth_loss,
                  'kpd_loss': keypoint_depth_loss, 'rot_loss': rot_loss,
                  'soft_depth_loss': soft_depth_loss}
    loss = sum(loss_stats[k] * w for k, w in LOSS_WEIGHTS.items())
    loss_stats['total_loss'] = loss
    return loss, loss_stats


def monoflex_decode(output: Dict[str, torch.Tensor], P2: torch.Tensor, image_hw,
                    score_thr: float = 0.1, nms_iou_thr: float = 0.5, top_k: int = 100,
                    max_detections: int = 32, cls_agnostic: bool = True, down_ratio: int = 4,
                    uncertainty_range=(-10.0, 10.0)) -> Dict[str, torch.Tensor]:
    """Heatmap decode -> 3D boxes, fixed shapes, on the device.

    output: NHWC maps [B, H, W, C] in f32; P2 [B, 3, 4]. Returns dict(scores
    [B, K], bboxes [B, K, 11] (2D box, projected 3D center and depth,
    dimensions, alpha), labels [B, K], valid [B, K]), K = max_detections.
    """
    hm = torch.sigmoid(output['hm'])
    heat = rtm.heatmap_nms(hm)
    scores, inds, clses, ys, xs = rtm.topk(heat, k=top_k)  # [B, K]

    g = _gather_all(output, inds)
    bbox2d = _decode_fcos_bbox(g['bbox2d'], torch.stack([xs, ys], dim=-1))
    merged_depth = _fused_depth(g, P2, uncertainty_range)[-1]  # [B, K]

    alpha = rtm.decode_alpha_from_bins(g['rot'])[..., None]
    cx3d = (xs + g['offset'][..., 0])[..., None] * down_ratio
    cy3d = (ys + g['offset'][..., 1])[..., None] * down_ratio
    z3d = merged_depth[..., None]
    bbox2d = clip_boxes(bbox2d * down_ratio, image_hw)

    boxes11 = torch.cat([bbox2d, cx3d, cy3d, z3d, g['dim'], alpha], dim=2)
    labels = clses
    valid = scores > score_thr
    nms_boxes = boxes11[..., :4]
    if not cls_agnostic:
        top = boxes11.amax(dim=(1, 2), keepdim=True)
        nms_boxes = nms_boxes + labels.to(nms_boxes.dtype)[..., None] * top
    keep_idx, keep_valid = nms(nms_boxes, scores, nms_iou_thr, max_outputs=max_detections,
                               pre_top_k=top_k, valid_mask=valid)
    safe = keep_idx.clamp(min=0).long()
    return dict(scores=scores.gather(1, safe) * keep_valid,
                bboxes=boxes11.gather(1, safe[..., None].expand(-1, -1, 11)),
                labels=labels.gather(1, safe),
                valid=keep_valid)
