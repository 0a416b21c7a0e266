"""Box geometry (counterpart of ``visualdet3d_tpu/geometry.py``): the 2-D
box helpers on tensors (leading batch dimensions broadcast), and the 3-D
corner matrix and alpha/theta conversions on numpy arrays or floats, for
the host-side target builders."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# corner order of the 3-D box projection (the order the keypoint heads and
# the 9-point RTM3D targets use): half-extents' signs per (x, y, z)
CORNER_MATRIX = np.array(
    [[-1, -1, -1],
     [1, -1, -1],
     [1, 1, -1],
     [1, 1, 1],
     [1, -1, 1],
     [-1, -1, 1],
     [-1, 1, 1],
     [-1, 1, -1]], dtype=np.float32)  # [8, 3]


def alpha2theta_3d(alpha, x, z, P2):
    """Observation angle alpha -> yaw theta from the 3-D position (x, z)."""
    offset = P2[..., 0, 3] / P2[..., 0, 0]
    return alpha + np.arctan2(x + offset, z)


def theta2alpha_3d(theta, x, z, P2):
    """Yaw theta -> observation angle alpha from the 3-D position (x, z)."""
    offset = P2[..., 0, 3] / P2[..., 0, 0]
    return theta - np.arctan2(x + offset, z)


def calc_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between boxes a [..., N, 4] and b [..., M, 4] -> [..., N, M]."""
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]))
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]))
    iw = iw.clamp(min=0)
    ih = ih.clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    ua = area_a[..., :, None] + area_b[..., None, :] - iw * ih
    ua = ua.clamp(min=1e-8)
    return iw * ih / ua


def clip_boxes(boxes: torch.Tensor, image_hw: Tuple[int, int]) -> torch.Tensor:
    """Clamp [..., >=4] boxes (first 4 entries x1,y1,x2,y2) to the image."""
    height, width = image_hw
    x1 = boxes[..., 0].clamp(min=0)
    y1 = boxes[..., 1].clamp(min=0)
    x2 = boxes[..., 2].clamp(max=width)
    y2 = boxes[..., 3].clamp(max=height)
    return torch.cat([torch.stack([x1, y1, x2, y2], dim=-1), boxes[..., 4:]], dim=-1)
