"""Detection losses (counterpart of ``visualdet3d_tpu/models/heads/losses.py``).

Only the IoU loss of the MonoFlex head is ported; the focal, smooth-L1 and
stereo disparity losses come with stereo training.
"""
from __future__ import annotations

import torch


def iou_loss(preds: torch.Tensor, targets: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """-log(IoU) between aligned boxes [..., 4] (x1, y1, x2, y2)."""
    lt = torch.maximum(preds[..., :2], targets[..., :2])
    rb = torch.minimum(preds[..., 2:], targets[..., 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    ap = (preds[..., 2] - preds[..., 0]) * (preds[..., 3] - preds[..., 1])
    ag = (targets[..., 2] - targets[..., 0]) * (targets[..., 3] - targets[..., 1])
    union = ap + ag - overlap + eps
    ious = (overlap / union).clamp(min=eps)
    return -torch.log(ious)
