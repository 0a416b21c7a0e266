"""Rotated-rectangle overlap for the offline KITTI evaluator (counterpart of
``visualdet3d_tpu/evaluator/kitti_object/rotate_iou.py``).

Replaces the reference's numba.cuda kernels
(visualDet3D/evaluator/kitti/rotate_iou.py:12-328) with the port's
branch-free polygon clipping (``ops/rotated_iou.py``) in torch on the host,
in float32, as the JAX package computes it on its CPU backend. Every pair of
a call goes through one batched clipping; there are no padding buckets (the
JAX package pads only so that XLA reuses its compiled code).

Box format here matches the devkit: [cx, cy, w, h, angle] where angle is
rotation_y; criterion -1 = IoU, 0 = overlap/area_a, 1 = overlap/area_b,
2 = raw intersection area.
"""
from __future__ import annotations

import numpy as np
import torch

from visualdet3d_tpu_torch.ops.rotated_iou import _pair_intersection_area, _pairwise, rect_corners


@torch.no_grad()
def rotated_box_intersection(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """[N, 5] x [K, 5] -> [N, K] intersection areas (numpy in/out; float32
    arithmetic, float64 out)."""
    n, k = boxes_a.shape[0], boxes_b.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float64)
    a, b = _pairwise(torch.as_tensor(np.asarray(boxes_a, np.float32)),
                     torch.as_tensor(np.asarray(boxes_b, np.float32)))
    inter = _pair_intersection_area(rect_corners(a), rect_corners(b))
    return inter.reshape(n, k).numpy().astype(np.float64)


def rotate_iou_eval(boxes: np.ndarray, query_boxes: np.ndarray,
                    criterion: int = -1) -> np.ndarray:
    """Devkit-compatible rotated overlap (reference rotate_iou.py:292-328)."""
    inter = rotated_box_intersection(boxes, query_boxes)
    area_a = np.abs(boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = np.abs(query_boxes[:, 2] * query_boxes[:, 3])[None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a, inter.shape).copy()
    elif criterion == 1:
        denom = np.broadcast_to(area_b, inter.shape).copy()
    else:
        return inter
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


# keep the reference entry-point name for drop-in use
rotate_iou_gpu_eval = rotate_iou_eval
