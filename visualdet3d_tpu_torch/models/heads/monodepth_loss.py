"""The supervised depth losses of MonoDepth (counterpart of the parts of
``visualdet3d_tpu/models/heads/monodepth_loss.py`` that ``MonoDepth.loss``
calls): forward differences with the edge replicated, the edge-aware
smoothness, the inverse-depth max-pool that brings sparse ground truth to
an output's size, and the scale-invariant log loss. Maps are NHWC, as in
the JAX package.

The self-supervised family of that module (``apply_disparity``, ``ssim``,
``scale_pyramid``, ``monodepth_self_supervised_loss``) has no caller in the
JAX package and is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def gradient_x(img: torch.Tensor) -> torch.Tensor:
    """Horizontal forward difference with the last column replicated:
    ``img[:, :, x] - img[:, :, x + 1]``. img: [B, H, W, C]."""
    return img - torch.cat([img[:, :, 1:], img[:, :, -1:]], dim=2)


def gradient_y(img: torch.Tensor) -> torch.Tensor:
    """The vertical forward difference, the last row replicated."""
    return img - torch.cat([img[:, 1:], img[:, -1:]], dim=1)


def smooth_loss(depth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness: the depth's gradients weighted by
    ``exp(-20 * mean_c |image gradient|)``, averaged."""
    dgx, dgy = gradient_x(depth), gradient_y(depth)
    wx = torch.exp(-20 * gradient_x(image).abs().mean(dim=-1, keepdim=True))
    wy = torch.exp(-20 * gradient_y(image).abs().mean(dim=-1, keepdim=True))
    return ((dgx * wx).abs() + (dgy * wy).abs()).mean()


def reshape_depth(gt_depth: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Sparse depth [B, H, W] down to ``shape`` by max-pooling the inverse
    depth over windows of (H // h, W // w), VALID (the nearest return of
    each cell); a cell without a return is 0."""
    inv = torch.where(gt_depth < 0.1, torch.full_like(gt_depth, 1e-9), 1.0 / (gt_depth + 1e-9))
    window = (gt_depth.shape[1] // shape[0], gt_depth.shape[2] // shape[1])
    pooled = F.max_pool2d(inv[:, None], window, window)[:, 0]
    return torch.where(pooled < 1e-8, torch.zeros_like(pooled), 1.0 / (pooled + 1e-9))


def si_log_loss(depth_prediction: torch.Tensor, reshaped_gt: torch.Tensor,
                max_depth: float = 50.0, si_lambda: float = 0.3) -> torch.Tensor:
    """Scale-invariant log loss over the valid pixels (ground truth in
    (0.1, max_depth), log difference above 0.001). Inputs [B, H, W]."""
    diff = torch.log(depth_prediction) - torch.log(reshaped_gt.clamp(min=1e-9))
    in_range = (reshaped_gt > 0.1) & (reshaped_gt < max_depth)
    num = in_range.sum().clamp(min=1).to(diff.dtype)
    diff = torch.where(in_range & (diff.abs() > 0.001), diff, torch.zeros_like(diff))
    return (diff ** 2).sum() / num - si_lambda * (diff.sum() / num) ** 2
