"""KM3D (RTM3D-style) center-based head (counterpart of
``visualdet3d_tpu/models/heads/km3d_head.py``): the per-branch conv towers,
the losses (CornerNet focal heatmap loss, depth-weighted keypoint L1, masked
L1s, the rotation-bin loss and the IoU3D-supervised position loss with its
exp-rampup weight) and the heatmap decode to 3D boxes.

The JAX package decodes one image at a time and ``vmap``s the decoder over
the batch; here the decode is written for a batch, with every op
per-image, so that a batched decode equals the per-image one.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from visualdet3d_tpu_torch.geometry import clip_boxes
from visualdet3d_tpu_torch.models.heads import rtm3d_utils as rtm
from visualdet3d_tpu_torch.ops.nms import nms
from visualdet3d_tpu_torch.parallel.mesh import all_sum

# branch name -> output channels (reference config KM3D_example)
DEFAULT_HEAD_DICT = {'hm': 3, 'wh': 2, 'hps': 18, 'rot': 8, 'dim': 3,
                     'prob': 1, 'reg': 2, 'hm_hp': 9, 'hp_offset': 2}
HM_BIAS = -2.19  # the heatmap branches' initial bias: sigmoid(-2.19) = 0.1


class KM3DHeadNet(nn.Module):
    """Per-branch conv towers: ``{name}_conv1`` (3x3, ReLU) and
    ``{name}_out`` (1x1). Returns a dict of NCHW (channels_last) maps."""

    def __init__(self, in_channels: int, head_dict: Sequence[Tuple[str, int]],
                 head_features: int = 64):
        super().__init__()
        self.head_dict = tuple(head_dict)
        for name, channels in self.head_dict:
            self.add_module(f'{name}_conv1', nn.Conv2d(in_channels, head_features, 3, padding=1))
            self.add_module(f'{name}_out', nn.Conv2d(head_features, channels, 1))

    @torch.no_grad()
    def reset_out_convs(self, generator: torch.Generator) -> None:
        """The flax initialisers of the output convs: heatmap branches
        lecun-normal with bias -2.19, the others normal(0.001) with bias 0."""
        for name, _ in self.head_dict:
            conv = getattr(self, f'{name}_out')
            std = (1.0 / conv.weight[0].numel()) ** 0.5 if 'hm' in name else 0.001
            w = torch.randn(conv.weight.shape, generator=generator) * std
            conv.weight.copy_(w.to(conv.weight.device))
            conv.bias.fill_(HM_BIAS if 'hm' in name else 0.0)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, f'{name}_out')(F.relu(getattr(self, f'{name}_conv1')(x)))
                for name, _ in self.head_dict}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def neg_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CornerNet focal loss on heatmaps with over-confidence clamps.
    pred (raw logits) / gt: [B, H, W, C]."""
    pos_inds = (gt == 1.0).to(pred.dtype)
    neg_inds = (gt < 1.0).to(pred.dtype)
    neg_weights = (1.0 - gt) ** 4
    pred_prob = torch.sigmoid(pred)

    pos_loss = F.logsigmoid(pred) * (1 - pred_prob) ** 2 * pos_inds
    pos_loss = torch.where(pred_prob > 0.99, 0.0, pos_loss)
    neg_loss_ = F.logsigmoid(-pred) * pred_prob ** 2 * neg_weights * neg_inds
    neg_loss_ = torch.where(pred_prob < 0.01, 0.0, neg_loss_)

    num_pos = all_sum(pos_inds.sum())
    pos_sum = all_sum(pos_loss.sum())
    neg_sum = all_sum(neg_loss_.sum())
    return torch.where(num_pos == 0, -neg_sum, -(pos_sum + neg_sum) / num_pos.clamp(min=1))


def reg_weighted_l1_loss(output, mask, ind, target, dep):
    """Depth-weighted keypoint L1."""
    dep = dep[..., 0]
    dep = torch.where(dep < 5, dep * 0.01, torch.log10((dep - 4).clamp(min=1e-6)) + 0.1)
    pred = rtm.transpose_and_gather_feat(output, ind)
    mask = mask.to(pred.dtype)
    loss = (pred * mask - target * mask).abs()
    loss = loss.sum(dim=2) * dep
    return all_sum(loss.sum()) / (all_sum(mask.sum()) + 1e-4)


def reg_l1_loss(output, mask, ind, target):
    """Masked L1."""
    pred = rtm.transpose_and_gather_feat(output, ind)
    mask = mask[..., None].expand(pred.shape).to(pred.dtype)
    return all_sum((pred * mask - target * mask).abs().sum()) / (all_sum(mask.sum()) + 1e-4)


def exp_rampup(epoch, rampup_length: int = 100):
    epoch = torch.as_tensor(epoch, dtype=torch.float32).clamp(0.0, rampup_length)
    phase = 1.0 - epoch / rampup_length
    return torch.exp(-5.0 * phase * phase)


LOSS_WEIGHTS = {'hm_loss': 1, 'hp_loss': 1, 'hm_hp_loss': 1, 'hp_offset_loss': 1,
                'wh_loss': 0.1, 'off_loss': 1, 'dim_loss': 2, 'rot_loss': 0.2}


def km3d_loss(output: Dict[str, torch.Tensor], annotations: Dict[str, torch.Tensor],
              P2: torch.Tensor, epoch, output_w: int, rampup_length: int = 100):
    """The full KM3D loss: (total, the per-term dict with ``total_loss``).
    output: NHWC f32 maps; annotations: the target builder's tensors."""
    ann = annotations
    ind = ann['ind'].long()
    hm_loss = neg_loss(output['hm'], ann['hm'])
    hp_loss = reg_weighted_l1_loss(output['hps'], ann['hps_mask'], ind, ann['hps'], ann['dep'])
    wh_loss = reg_l1_loss(output['wh'], ann['reg_mask'], ind, ann['wh'])
    dim_loss = reg_l1_loss(output['dim'], ann['reg_mask'], ind, ann['dim'])
    rot_pred = rtm.transpose_and_gather_feat(output['rot'], ind)
    rot_loss = rtm.compute_rot_loss(rot_pred, ann['rotbin'], ann['rotres'],
                                    ann['reg_mask'][..., None])
    off_loss = reg_l1_loss(output['reg'], ann['reg_mask'], ind, ann['reg'])
    hp_offset_loss = reg_l1_loss(output['hp_offset'], ann['hp_mask'], ann['hp_ind'].long(),
                                 ann['hp_offset'])
    hm_hp_loss = neg_loss(output['hm_hp'], ann['hm_hp'])
    coor_loss, prob_loss, box_score = rtm.position_loss(output, ann, P2, output_w)

    ramp = exp_rampup(epoch, rampup_length).to(hm_loss.device)
    loss_stats = {'hm_loss': hm_loss, 'hp_loss': hp_loss,
                  'hm_hp_loss': hm_hp_loss, 'hp_offset_loss': hp_offset_loss,
                  'wh_loss': wh_loss, 'off_loss': off_loss, 'dim_loss': dim_loss,
                  'rot_loss': rot_loss, 'prob_loss': prob_loss,
                  'box_score': box_score, 'coor_loss': coor_loss}
    weight = dict(LOSS_WEIGHTS, prob_loss=ramp, coor_loss=ramp)
    loss = sum(loss_stats[k] * w for k, w in weight.items())
    loss_stats['total_loss'] = loss
    return loss, loss_stats


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def km3d_decode(output: Dict[str, torch.Tensor], P2: torch.Tensor, image_hw,
                score_thr: float = 0.1, nms_iou_thr: float = 0.5, top_k: int = 100,
                max_detections: int = 32, cls_agnostic: bool = True,
                down_ratio: int = 4) -> Dict[str, torch.Tensor]:
    """Heatmap decode -> 3D boxes, fixed shapes, on the device.

    output: NHWC maps [B, H, W, C] in f32; P2 [B, 3, 4]. Returns dict(scores
    [B, K], bboxes [B, K, 11], labels [B, K], valid [B, K]),
    K = max_detections.
    """
    hm = torch.sigmoid(output['hm'])
    hm_hp = torch.sigmoid(output['hm_hp'])
    b = hm.shape[0]
    num_joints = output['hps'].shape[-1] // 2

    heat = rtm.heatmap_nms(hm)
    scores, inds, clses, ys, xs = rtm.topk(heat, k=top_k)  # [B, K]

    kps = rtm.transpose_and_gather_feat(output['hps'], inds)  # [B, K, 18]
    kps = torch.stack([kps[..., 0::2] + xs[..., None], kps[..., 1::2] + ys[..., None]],
                      dim=-1).reshape(b, top_k, 2 * num_joints)

    reg = rtm.transpose_and_gather_feat(output['reg'], inds)
    xs_c = xs[..., None] + reg[:, :, 0:1]
    ys_c = ys[..., None] + reg[:, :, 1:2]
    wh = rtm.transpose_and_gather_feat(output['wh'], inds)
    bboxes = torch.cat([xs_c - wh[..., 0:1] / 2, ys_c - wh[..., 1:2] / 2,
                        xs_c + wh[..., 0:1] / 2, ys_c + wh[..., 1:2] / 2], dim=2)
    dim = rtm.transpose_and_gather_feat(output['dim'], inds)
    rot = rtm.transpose_and_gather_feat(output['rot'], inds)

    # keypoint refinement from the vertex heatmaps
    kps_grid = kps.reshape(b, top_k, num_joints, 2).transpose(1, 2)  # [B, J, K, 2]
    hm_score, hm_inds, hm_ys, hm_xs = rtm.topk_channel(rtm.heatmap_nms(hm_hp), k=top_k)
    hp_offset = rtm.transpose_and_gather_feat(
        output['hp_offset'], hm_inds.reshape(b, -1)).reshape(b, num_joints, top_k, 2)
    hm_xs = hm_xs + hp_offset[..., 0]
    hm_ys = hm_ys + hp_offset[..., 1]
    thresh = 0.1
    m = (hm_score > thresh).to(hm_xs.dtype)
    hm_score_m = (1 - m) * -1 + m * hm_score
    hm_ys_m = (1 - m) * (-10000) + m * hm_ys
    hm_xs_m = (1 - m) * (-10000) + m * hm_xs
    hm_kps = torch.stack([hm_xs_m, hm_ys_m], dim=-1)  # [B, J, K, 2]
    diff = kps_grid[:, :, :, None] - hm_kps[:, :, None]
    dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    min_dist, min_ind = dist.min(dim=3)  # [B, J, K]; the first minimum, as argmin
    picked_score = hm_score_m.gather(2, min_ind)[..., None]
    picked_kps = hm_kps.gather(2, min_ind[..., None].expand(*min_ind.shape, 2))
    l_box = bboxes[:, None, :, 0:1]
    t_box = bboxes[:, None, :, 1:2]
    r_box = bboxes[:, None, :, 2:3]
    b_box = bboxes[:, None, :, 3:4]
    bad = ((picked_kps[..., 0:1] < l_box) | (picked_kps[..., 0:1] > r_box) |
           (picked_kps[..., 1:2] < t_box) | (picked_kps[..., 1:2] > b_box) |
           (picked_score < thresh) |
           (min_dist[..., None] > torch.maximum(b_box - t_box, r_box - l_box) * 0.3))
    refined = torch.where(bad, kps_grid, picked_kps)
    kps = refined.transpose(1, 2).reshape(b, top_k, num_joints * 2)

    kps = kps * down_ratio
    bboxes = bboxes * down_ratio

    position, _, alpha, _ = rtm.gen_position(kps, dim, rot, P2)

    # camera-frame -> image-frame center
    fx, fy = P2[:, None, 0, 0:1], P2[:, None, 1, 1:2]
    cx, cy = P2[:, None, 0, 2:3], P2[:, None, 1, 2:3]
    tx, ty = P2[:, None, 0, 3:4], P2[:, None, 1, 3:4]
    z3d = position[..., 2:3]
    cx3d = (position[..., 0:1] * fx + tx + cx * z3d) / z3d
    cy3d = (position[..., 1:2] * fy + ty + cy * z3d) / z3d

    bbox2d = clip_boxes(bboxes, image_hw)
    boxes11 = torch.cat([bbox2d, cx3d, cy3d, z3d, dim, alpha], dim=2)  # [B, K, 11]

    valid = scores > score_thr
    labels = clses
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
