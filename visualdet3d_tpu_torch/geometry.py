"""Box geometry on tensors (counterpart of the 2-D box helpers in
``visualdet3d_tpu/geometry.py``). Leading batch dimensions broadcast."""
from __future__ import annotations

from typing import Tuple

import torch


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
