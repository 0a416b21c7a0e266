"""RTM3D/KM3D utilities (counterpart of
``visualdet3d_tpu/models/heads/rtm3d_utils.py``). Host side (numpy): the
gaussian heatmap stamping of the target builder. Device side (torch): heatmap
max-pool NMS, top-K peak extraction, feature gathering by flat indices, the
rotation-bin loss, the multibin alpha decode, MonoFlex's two depth decodes,
the batched 16x3 least-squares 3D position solve and the IoU3D-supervised
position loss.
Maps are NHWC ``[B, H, W, C]``, as in the JAX package.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values, and
after ``heatmap_nms`` most of a map is exactly 0, so ties are the rule.
``_topk`` is a stable descending sort, which keeps that order.

Every reduction in ``gen_position`` is written as elementwise operations in
a fixed order, so that a batched decode equals the per-image one exactly on
the card (a library matmul may pick another summation order for another
batch size).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from visualdet3d_tpu_torch.ops.rotated_iou import aligned_boxes_iou3d


# ---------------------------------------------------------------------------
# host-side target helpers (numpy)
# ---------------------------------------------------------------------------

def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet gaussian radius."""
    height, width = det_size
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(b1 ** 2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2
    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2 ** 2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def gaussian_2d(shape, sigma: float = 1.0) -> np.ndarray:
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def gen_hm_radius(heatmap: np.ndarray, center, radius: int, k: float = 1.0):
    """Stamp a gaussian peak into heatmap [H, W] in place."""
    diameter = 2 * radius + 1
    gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    masked_heatmap = heatmap[y - top:y + bottom, x - left:x + right]
    masked_gaussian = gaussian[radius - top:radius + bottom, radius - left:radius + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


# ---------------------------------------------------------------------------
# device-side ops (torch, NHWC)
# ---------------------------------------------------------------------------


def heatmap_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima (3x3 max-pool trick). heat: [B, H, W, C]."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, 1, pad).permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, 0.0)


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat [B, HW, C], ind [B, K] -> [B, K, C]."""
    return feat.gather(1, ind[..., None].expand(-1, -1, feat.shape[-1]))


def transpose_and_gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat [B, H, W, C], ind [B, K] flat y*W+x -> [B, K, C]."""
    b, h, w, c = feat.shape
    return gather_feat(feat.reshape(b, h * w, c), ind)


def _topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first among ties (the order
    of ``jax.lax.top_k``)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def topk(scores: torch.Tensor, k: int = 40):
    """Per-class then global top-K peaks. scores: [B, H, W, C]. Returns
    (score, flat_inds, cls, ys, xs), all [B, K]."""
    b, h, w, c = scores.shape
    per_class = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    topk_scores, topk_inds = _topk(per_class, k)  # [B, C, K]
    topk_ys = (topk_inds // w).float()
    topk_xs = (topk_inds % w).float()
    topk_score, topk_ind = _topk(topk_scores.reshape(b, c * k), k)  # [B, K]
    topk_clses = (topk_ind // k).int()

    def flat(x):
        return x.reshape(b, c * k).gather(1, topk_ind)
    return topk_score, flat(topk_inds), topk_clses, flat(topk_ys), flat(topk_xs)


def topk_channel(scores: torch.Tensor, k: int = 40):
    """Per-channel top-K. scores: [B, H, W, C] -> each [B, C, K]."""
    b, h, w, c = scores.shape
    per_class = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    topk_scores, topk_inds = _topk(per_class, k)
    return topk_scores, topk_inds, (topk_inds // w).float(), (topk_inds % w).float()


def _masked_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """CE over all rows with logits zeroed where mask == 0 (masked rows
    contribute the constant log(2) with zero gradient)."""
    logp = torch.log_softmax(logits * mask, dim=-1)
    return -logp.gather(-1, target[:, None])[:, 0].mean()


def _smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def compute_rot_loss(output: torch.Tensor, target_bin: torch.Tensor, target_res: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """output [*, 8] = [bin1_cls(2), bin1_sin, bin1_cos, bin2_cls(2),
    bin2_sin, bin2_cos]; target_bin [*, 2]; target_res [*, 2]; mask [*, 1]."""
    output = output.reshape(-1, 8)
    target_bin = target_bin.reshape(-1, 2).long()
    target_res = target_res.reshape(-1, 2)
    mask = mask.reshape(-1, 1).to(output.dtype)

    loss_bin1 = _masked_cross_entropy(output[:, 0:2], target_bin[:, 0], mask)
    loss_bin2 = _masked_cross_entropy(output[:, 4:6], target_bin[:, 1], mask)

    def res_branch(sin_idx, cos_idx, bin_col):
        sel = (target_bin[:, bin_col] != 0).to(output.dtype)
        denom = sel.sum().clamp(min=1.0)
        loss_sin = (_smooth_l1(output[:, sin_idx], torch.sin(target_res[:, bin_col]))
                    * sel).sum() / denom
        loss_cos = (_smooth_l1(output[:, cos_idx], torch.cos(target_res[:, bin_col]))
                    * sel).sum() / denom
        return torch.where(sel.sum() > 0, loss_sin + loss_cos, 0.0)

    return loss_bin1 + loss_bin2 + res_branch(2, 3, 0) + res_branch(6, 7, 1)


def _solve3x3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Solve m @ x = v for batched 3x3 m ([..., 3, 3]) via the adjugate:
    elementwise arithmetic only, so batching does not change the result."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / det
    x0 = (c00 * v[..., 0] + c01 * v[..., 1] + c02 * v[..., 2]) * inv_det
    x1 = (c10 * v[..., 0] + c11 * v[..., 1] + c12 * v[..., 2]) * inv_det
    x2 = (c20 * v[..., 0] + c21 * v[..., 1] + c22 * v[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


# per-row unit pattern of the 16x3 system: rows alternate (-1, 0) / (0, -1)
_CONST = np.tile(np.array([[-1.0, 0.0], [0.0, -1.0]], np.float32), (8, 1))  # [16, 2]

# corner order of the JAX package's geometry.CORNER_MATRIX:
#   B[2i]   = _L_COS[i]*l/2*cos + _W_SIN[i]*w/2*sin
#   B[2i+1] = _H_SIGN[i]*h/2
#   C[2i] = C[2i+1] = _L_SIN[i]*l/2*sin + _W_COS[i]*w/2*cos
_L_COS = np.array([-1, -1, -1, +1, +1, +1, +1, -1], np.float32)
_H_SIGN = np.array([-1, -1, +1, +1, -1, -1, +1, +1], np.float32)
_L_SIN = np.array([+1, +1, +1, -1, -1, -1, -1, +1], np.float32)
_W_SIN = np.array([-1, +1, +1, +1, +1, -1, -1, -1], np.float32)
_W_COS = np.array([-1, +1, +1, +1, +1, -1, -1, -1], np.float32)


def decode_alpha_from_bins(rot: torch.Tensor) -> torch.Tensor:
    """rot [*, 8] multibin -> alpha [*]."""
    alpha_idx = (rot[..., 1] > rot[..., 5]).to(rot.dtype)
    alpha1 = torch.atan(rot[..., 2] / rot[..., 3]) - 0.5 * math.pi
    alpha2 = torch.atan(rot[..., 6] / rot[..., 7]) + 0.5 * math.pi
    return alpha1 * alpha_idx + alpha2 * (1 - alpha_idx)


def decode_depth_inv_sigmoid(depth: torch.Tensor) -> torch.Tensor:
    """MonoFlex's direct depth: exp(-x)."""
    return torch.exp(-depth)


def decode_depth_from_keypoints(keypoints: torch.Tensor, dimensions: torch.Tensor,
                                calib: torch.Tensor, down_ratio: int = 4,
                                min_depth: float = 0.1, max_depth: float = 100.0,
                                eps: float = 1e-8) -> torch.Tensor:
    """MonoFlex keypoint depths. keypoints [*, 10, 2] (stride-4 map units);
    dimensions [*, 3] (w, h, l); calib [*, 3, 4] -> [*, 3] depths: from the
    center pair (the bottom and top face centers) and the mean of each
    diagonal group. Each group pairs a bottom corner with the top corner
    above it: (7, 3) with (0, 4), (2, 6) with (1, 5). No gradient flows into
    the predicted height."""
    pred_h = dimensions[..., 1].detach()
    center_height = keypoints[..., 8, 1] - keypoints[..., 9, 1]
    corner_02 = keypoints[..., [7, 3], 1] - keypoints[..., [0, 4], 1]
    corner_13 = keypoints[..., [2, 6], 1] - keypoints[..., [1, 5], 1]

    f = calib[..., 0, 0]
    center_depth = f * pred_h / (F.relu(center_height) * down_ratio + eps)
    corner_02_depth = ((f * pred_h)[..., None] /
                       (F.relu(corner_02) * down_ratio + eps)).mean(dim=-1)
    corner_13_depth = ((f * pred_h)[..., None] /
                       (F.relu(corner_13) * down_ratio + eps)).mean(dim=-1)
    depths = torch.stack([center_depth, corner_02_depth, corner_13_depth], dim=-1)
    return depths.clamp(min_depth, max_depth)


def gen_position(kps: torch.Tensor, dim: torch.Tensor, rot: torch.Tensor,
                 calib: torch.Tensor):
    """Solve each object's 3D center from its 9 projected keypoints.

    kps [B, K, 18] absolute keypoint image coords at input scale ((x, y) x 9,
    the center last); dim [B, K, 3] (w, h, l); rot [B, K, 8] multibin;
    calib [B, 3, 4]. Returns position [B, K, 3], rot_y [B, K, 1],
    alpha_pre [B, K, 1] and kps.
    """
    b, k = kps.shape[0], kps.shape[1]
    dev, dt = kps.device, kps.dtype
    off_set = calib[:, 0, 3] / calib[:, 0, 0]  # [B]
    si = calib[:, None, 0, 0].expand(b, k)

    alpha_pre = decode_alpha_from_bins(rot)
    rot_y = alpha_pre + torch.atan2(kps[:, :, 16] - calib[:, None, 0, 2], si)
    rot_y = torch.where(rot_y > math.pi, rot_y - 2 * math.pi, rot_y)
    rot_y = torch.where(rot_y < -math.pi, rot_y + 2 * math.pi, rot_y)

    kpoint = kps[:, :, :16]
    f = calib[:, None, 0, 0][..., None]                                   # [B, 1, 1]
    cx, cy = calib[:, None, 0, 2][..., None], calib[:, None, 1, 2][..., None]
    cxy = torch.cat([cx, cy], dim=2).repeat(1, 1, 8)                      # [B, 1, 16]
    kp_norm = (kpoint - cxy) / f                                          # [B, K, 16]

    w, h, l = dim[:, :, 0:1], dim[:, :, 1:2], dim[:, :, 2:3]
    cosori = torch.cos(rot_y)[..., None]
    sinori = torch.sin(rot_y)[..., None]
    lc = 0.5 * l * cosori
    ls = 0.5 * l * sinori
    wc = 0.5 * w * cosori
    ws = 0.5 * w * sinori
    hh = 0.5 * h * torch.ones_like(lc)

    def const(a):
        return torch.as_tensor(a, dtype=dt, device=dev)
    bx = const(_L_COS) * lc + const(_W_SIN) * ws                          # [B, K, 8]
    by = const(_H_SIGN) * hh
    b_vec = torch.stack([bx, by], dim=-1).reshape(b, k, 16)
    c_even = const(_L_SIN) * ls + const(_W_COS) * wc
    c_vec = c_even.repeat_interleave(2, dim=-1)                           # [B, K, 16]
    b_vec = b_vec - kp_norm * c_vec

    a_mat = torch.cat([const(_CONST).expand(b, k, 16, 2), kp_norm[..., None]], dim=-1)
    # [A | b] -> A^T A and A^T b, summed over the 16 rows in order
    ab = torch.cat([a_mat, b_vec[..., None]], dim=-1)                     # [B, K, 16, 4]
    normal = ab[..., 0, :3, None] * ab[..., 0, None, :]
    for r in range(1, 16):
        normal = normal + ab[..., r, :3, None] * ab[..., r, None, :]      # [B, K, 3, 4]
    m = normal[..., :3] + 1e-5 * torch.eye(3, dtype=dt, device=dev)
    position = _solve3x3(m, normal[..., 3])                               # [B, K, 3]
    position = torch.cat([position[..., :1] - off_set[:, None, None], position[..., 1:]], -1)
    return position, rot_y[..., None], alpha_pre[..., None], kps


def position_loss(output: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                  calib: torch.Tensor, output_w: int):
    """IoU3D-supervised position and confidence loss. output maps are NHWC;
    batch carries the RTM3D targets. Returns (coor_loss, prob_loss,
    box_score_mean). No gradient flows through rot or the 3-D IoU."""
    ind = batch['ind'].long()
    dim = transpose_and_gather_feat(output['dim'], ind)
    rot = transpose_and_gather_feat(output['rot'], ind).detach()
    prob = transpose_and_gather_feat(output['prob'], ind)
    kps = transpose_and_gather_feat(output['hps'], ind)

    b, c = dim.shape[0], dim.shape[1]
    mask = batch['hps_mask'].float()  # [B, C, 18]

    cys = (ind // output_w).float()
    cxs = (ind % output_w).float()
    kps = torch.stack([kps[..., 0::2] + cxs[..., None], kps[..., 1::2] + cys[..., None]],
                      dim=-1).reshape(kps.shape)

    position, rot_y, _, _ = gen_position(kps * 4, dim, rot, calib)

    loss_mask = (mask.sum(dim=2) > 15).float()
    dim_neg = dim < 0
    dim = dim.clamp(0, 10)
    dim_ok = 1.0 - (dim_neg.sum(dim=2) > 0).float()

    loss_norm = torch.linalg.norm(position - batch['location'], dim=2)
    mask_num = (loss_mask != 0).sum()
    coor_loss = (loss_norm * loss_mask).sum() / (mask_num + 1)

    dim_gt = torch.where(dim_neg, 0.0, batch['dim'])
    with torch.no_grad():
        box_pred = torch.cat([position, dim, rot_y], dim=2).reshape(b * c, 7)
        gt_box = torch.cat([batch['location'], dim_gt, batch['ori']], dim=2).reshape(b * c, 7)
        # aligned-pair 3D IoU
        box_score = aligned_boxes_iou3d(box_pred, gt_box).reshape(b, c)
    prob = prob[..., 0]
    box_score = box_score * loss_mask * dim_ok
    loss_prob = -(box_score * F.logsigmoid(prob) + (1 - box_score) * F.logsigmoid(-prob))
    loss_prob = (loss_prob * loss_mask * dim_ok).sum() / (mask_num + 1)
    box_score_mean = (box_score * loss_mask).sum() / (mask_num + 1e-3)
    return coor_loss, loss_prob, box_score_mean
