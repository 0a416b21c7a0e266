"""Detection and disparity losses (counterpart of
``visualdet3d_tpu/models/heads/losses.py``): elementwise, batched and
mask-driven, with no host sync.

- the sigmoid focal loss with ignore (-1) and the tiny-loss clamp, the
  modified smooth-L1 with its dead zone, elementwise BCE on logits (the
  anchor head's classification and regression terms);
- the IoU loss (MonoFlex);
- the stereo focal loss over Laplace (or Gaussian, one-hot) ground-truth
  disparity probability volumes (YOLOStereo3D's disparity head).

``softmax_focal_loss`` has no caller in the port and is not ported.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from visualdet3d_tpu_torch.parallel.mesh import global_mean


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 0.0,
                       balance_weights: Union[torch.Tensor, float] = 1.0) -> torch.Tensor:
    """Per-element sigmoid focal loss: logits and targets [..., classes],
    targets in {-1 (ignored), 0, 1}; ``balance_weights`` weighs the positive
    term per class. Ignored entries and entries below 1e-5 are exactly 0
    (the clamp keeps confident correct predictions from overfitting)."""
    probs = torch.sigmoid(logits)
    focal_weight = torch.where(targets == 1.0, 1.0 - probs, probs) ** gamma
    bce = -(targets * F.logsigmoid(logits)) * balance_weights \
        - (1.0 - targets) * F.logsigmoid(-logits)
    loss = focal_weight * bce
    loss = torch.where(targets == -1.0, torch.zeros_like(loss), loss)
    return torch.where(loss < 1e-5, torch.zeros_like(loss), loss)


def modified_smooth_l1(targets: torch.Tensor, preds: torch.Tensor,
                       alpha: float = 25.0) -> torch.Tensor:
    """Smooth-L1 with its knee at 1/alpha and a dead zone |diff| <= 0.01."""
    diff = (targets - preds).abs()
    loss = torch.where(diff <= 1.0 / alpha, 0.5 * alpha * diff ** 2, diff - 0.5 / alpha)
    return torch.where(diff <= 0.01, torch.zeros_like(loss), loss)


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


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on logits (no reduction)."""
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


# ---------------------------------------------------------------------------
# Stereo focal loss (disparity supervision of the cost volume)
# ---------------------------------------------------------------------------

def _disp_mask(gt_disp: torch.Tensor, num_disp: int):
    index = torch.arange(num_disp, dtype=gt_disp.dtype, device=gt_disp.device)
    return index, (gt_disp > 0) & (gt_disp < num_disp - 1)


def laplace_disp_probability(gt_disp: torch.Tensor, num_disp: int, variance: float = 1.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth disparity [..., H, W] (0 marks invalid) -> (the Laplace
    probability volume [..., H, W, D], the valid mask [..., H, W]); rows of
    invalid pixels are 0 + 1e-40."""
    index, mask = _disp_mask(gt_disp, num_disp)
    gt = torch.where(mask, gt_disp, torch.zeros_like(gt_disp))
    prob = torch.softmax(-(index - gt[..., None]).abs() / variance, dim=-1)
    return prob * mask[..., None] + 1e-40, mask


def gaussian_disp_probability(gt_disp: torch.Tensor, num_disp: int, variance: float = 1.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Gaussian variant of :func:`laplace_disp_probability`."""
    index, mask = _disp_mask(gt_disp, num_disp)
    gt = torch.where(mask, gt_disp, torch.zeros_like(gt_disp))
    prob = torch.softmax(-((index - gt[..., None]) ** 2) / variance, dim=-1)
    return prob * mask[..., None] + 1e-40, mask


def onehot_disp_probability(gt_disp: torch.Tensor, num_disp: int, variance: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-hot variant: 1 where |d - gt| < variance (of the unmasked
    ground truth), with the valid mask."""
    index, mask = _disp_mask(gt_disp, num_disp)
    prob = ((index - gt_disp[..., None]).abs() < variance).to(gt_disp.dtype)
    return prob, mask


def _downscale_disparity(gt_disp: torch.Tensor, out_hw, sparse: bool) -> torch.Tensor:
    """[B, H, W] disparity -> ``out_hw``, values divided by the width ratio;
    sparse ground truth max-pooled, dense averaged (windows of the integer
    ratio, VALID)."""
    _, h, w = gt_disp.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return gt_disp
    window = (h // oh, w // ow)
    scaled = (gt_disp / (w / ow))[:, None]
    if sparse:
        return F.max_pool2d(scaled, window, window)[:, 0]
    return F.avg_pool2d(scaled, window, window)[:, 0]


def stereo_focal_loss(est_cost: torch.Tensor, gt_disp: torch.Tensor, variance: float = 0.5,
                      focal_coefficient: float = 0.0, sparse: bool = False) -> torch.Tensor:
    """Focal cross-entropy between the estimated cost volume est_cost
    [B, H, W, D] (softmax taken here) and the Laplace ground-truth volume of
    gt_disp [B, Hg, Wg] (downscaled to H x W first); a scalar."""
    _, h, w, d = est_cost.shape
    gt = _downscale_disparity(gt_disp, (h, w), sparse)
    gt_prob, mask = laplace_disp_probability(gt, d, variance)
    weight = (1.0 - gt_prob) ** (-focal_coefficient)
    loss = -(gt_prob * F.log_softmax(est_cost, dim=-1) * weight
             * mask[..., None].to(est_cost.dtype))
    return global_mean(loss.sum(dim=-1))
