"""12-term 3D box target encode and decode against per-anchor statistical
priors (counterpart of ``visualdet3d_tpu/models/heads/target_coding.py``),
over all anchors with masks, batched over leading dimensions.

Term layout (12 regression channels + 1 alpha-hemisphere logit):
  [dx, dy, dw, dh, cdx, cdy, dz, d_sin2a, d_cos2a, dw3d, dh3d, dl3d] (+alpha)
Annotation row layout:
  [x1, y1, x2, y2, cls, cx, cy, z, w, h, l, alpha]
"""
from __future__ import annotations

import math

import torch

# fixed normalisation stds
TARGET_STDS = (0.1, 0.1, 0.2, 0.2, 0.1, 0.1, 1, 1, 1, 1, 1, 1)


def _anchor_geometry(anchors: torch.Tensor):
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    cx = anchors[..., 0] + 0.5 * w
    cy = anchors[..., 1] + 0.5 * h
    return cx, cy, w, h


def encode(anchors: torch.Tensor, gt: torch.Tensor, mean_std: torch.Tensor):
    """Encode ground truth (gathered per anchor) against anchors and priors.

    Args:
      anchors: [..., 4]; gt: [..., 12] annotation rows of each anchor's
      assigned box; mean_std: [..., 6, 2] the prior (z, sin2a, cos2a, w, h,
      l) x (mean, std) of the box's class.
    Returns:
      targets: [..., 12] normalised regression targets.
      alpha_cls: [..., 1] in {0, 1}, the cos(alpha) > 0 hemisphere label.
    """
    px, py, pw, ph = _anchor_geometry(anchors)
    gx = 0.5 * (gt[..., 0] + gt[..., 2])
    gy = 0.5 * (gt[..., 1] + gt[..., 3])
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]

    eps = 1e-6
    m, s = mean_std[..., 0], mean_std[..., 1].clamp(min=eps)
    targets = torch.stack([
        (gx - px) / pw,
        (gy - py) / ph,
        torch.log((gw / pw).clamp(min=eps)),
        torch.log((gh / ph).clamp(min=eps)),
        (gt[..., 5] - px) / pw,
        (gt[..., 6] - py) / ph,
        (gt[..., 7] - m[..., 0]) / s[..., 0],
        (torch.sin(gt[..., 11] * 2) - m[..., 1]) / s[..., 1],
        (torch.cos(gt[..., 11] * 2) - m[..., 2]) / s[..., 2],
        (gt[..., 8] - m[..., 3]) / s[..., 3],
        (gt[..., 9] - m[..., 4]) / s[..., 4],
        (gt[..., 10] - m[..., 5]) / s[..., 5]], dim=-1)
    targets = targets / torch.tensor(TARGET_STDS, dtype=targets.dtype, device=targets.device)
    alpha_cls = (torch.cos(gt[..., 11:12]) > 0).to(targets.dtype)
    return targets, alpha_cls


def decode(anchors: torch.Tensor, deltas: torch.Tensor, mean_std: torch.Tensor,
           alpha_score: torch.Tensor):
    """Decode regression deltas to image-frame 3D boxes.

    Args:
      anchors: [..., 4]; deltas: [..., 12]; mean_std: [..., 6, 2] (prior
      already selected by predicted class); alpha_score: [..., 1] sigmoid.
    Returns:
      boxes: [..., 11] = [x1, y1, x2, y2, cx, cy, z, w, h, l, alpha].
      prior_ok: [...] bool, True where the prior's mean z > 0.
    """
    std = TARGET_STDS
    px, py, pw, ph = _anchor_geometry(anchors)

    dx = deltas[..., 0] * std[0]
    dy = deltas[..., 1] * std[1]
    dw = deltas[..., 2] * std[2]
    dh = deltas[..., 3] * std[3]
    pred_cx = px + dx * pw
    pred_cy = py + dy * ph
    pred_w = torch.exp(dw) * pw
    pred_h = torch.exp(dh) * ph

    x1 = pred_cx - 0.5 * pred_w
    y1 = pred_cy - 0.5 * pred_h
    x2 = pred_cx + 0.5 * pred_w
    y2 = pred_cy + 0.5 * pred_h

    m, s = mean_std[..., 0], mean_std[..., 1]
    prior_ok = m[..., 0] > 0

    cdx = deltas[..., 4] * std[4]
    cdy = deltas[..., 5] * std[5]
    cx3d = px + cdx * pw
    cy3d = py + cdy * ph
    z = deltas[..., 6] * s[..., 0] + m[..., 0]
    sin2a = deltas[..., 7] * s[..., 1] + m[..., 1]
    cos2a = deltas[..., 8] * s[..., 2] + m[..., 2]
    alpha = torch.atan2(sin2a, cos2a) / 2.0
    w3d = deltas[..., 9] * s[..., 3] + m[..., 3]
    h3d = deltas[..., 10] * s[..., 4] + m[..., 4]
    l3d = deltas[..., 11] * s[..., 5] + m[..., 5]

    # hemisphere disambiguation: alpha += pi when alpha_score < 0.5
    alpha = torch.where(alpha_score[..., 0] < 0.5, alpha + math.pi, alpha)

    boxes = torch.stack([x1, y1, x2, y2, cx3d, cy3d, z, w3d, h3d, l3d, alpha], dim=-1)
    return boxes, prior_ok


def select_mean_std_by_class(anchor_mean_std: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Each anchor's prior for its class: anchor_mean_std [..., T, 6, 2],
    labels [...] int -> [..., 6, 2]. A gather, exact like the JAX one-hot
    contraction."""
    t = anchor_mean_std.shape[-3]
    idx = labels.clamp(0, t - 1)[..., None, None, None]
    idx = idx.expand(*labels.shape, 1, *anchor_mean_std.shape[-2:])
    return torch.take_along_dim(anchor_mean_std, idx, dim=-3).squeeze(-3)
