"""Box geometry (counterpart of ``visualdet3d_tpu/geometry.py``): the 2-D
box helpers on tensors (leading batch dimensions broadcast), and the 3-D
corner matrix, alpha/theta conversions, the 3-D box projection, the
back-projection of image-frame box states and the annotation packing on
numpy arrays or floats, for the host-side data layer, the training targets
and evaluation."""
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


def convert_alpha_to_rot(alpha, cx, P2):
    """alpha + image-column ray angle -> global yaw, wrapped to (-pi, pi]
    (reference visualDet3D/utils/utils.py:30-37, convertAlpha2Rot)."""
    ry3d = alpha + np.arctan2(cx - P2[..., 0, 2], P2[..., 0, 0])
    ry3d = np.where(ry3d > np.pi, ry3d - 2 * np.pi, ry3d)
    return np.where(ry3d <= -np.pi, ry3d + 2 * np.pi, ry3d)


def convert_rot_to_alpha(ry3d, cx, P2):
    """Inverse of :func:`convert_alpha_to_rot` (reference utils.py:40-45,
    convertRot2Alpha)."""
    alpha = ry3d - np.arctan2(cx - P2[..., 0, 2], P2[..., 0, 0])
    alpha = np.where(alpha > np.pi, alpha - 2 * np.pi, alpha)
    return np.where(alpha <= -np.pi, alpha + 2 * np.pi, alpha)


def alpha2theta_3d(alpha, x, z, P2):
    """Observation angle alpha -> yaw theta from the 3-D position (x, z)."""
    offset = P2[..., 0, 3] / P2[..., 0, 0]
    return alpha + np.arctan2(x + offset, z)


def theta2alpha_3d(theta, x, z, P2):
    """Yaw theta -> observation angle alpha from the 3-D position (x, z)."""
    offset = P2[..., 0, 3] / P2[..., 0, 0]
    return theta - np.arctan2(x + offset, z)


def project_bbox3d(bbox_3d: np.ndarray, P2: np.ndarray):
    """Project [N, 7] boxes (x, y, z, w, h, l, alpha; y at the box centre)
    through P2 [3, 4]: (abs_corners [N, 8, 3] in the camera frame,
    homo_coord [N, 8, 3] in the image (x, y, depth-normalised), thetas [N]
    global yaw), in the boxes' dtype."""
    corner_matrix = CORNER_MATRIX.astype(bbox_3d.dtype)
    rel = 0.5 * corner_matrix[None, :, :] * bbox_3d[:, None, 3:6]
    thetas = alpha2theta_3d(bbox_3d[..., 6], bbox_3d[..., 0], bbox_3d[..., 2], P2)
    _cos = np.cos(thetas)[:, None]
    _sin = np.sin(thetas)[:, None]
    rot_x = rel[:, :, 2] * _cos + rel[:, :, 0] * _sin
    rot_z = -rel[:, :, 2] * _sin + rel[:, :, 0] * _cos
    abs_corners = np.stack([rot_x, rel[:, :, 1], rot_z], axis=-1) + bbox_3d[:, None, 0:3]
    ones = np.ones(abs_corners.shape[:-1] + (1,), dtype=abs_corners.dtype)
    camera_coord = np.einsum('ij,nkj->nki', P2, np.concatenate([abs_corners, ones], axis=-1))
    homo_coord = camera_coord / (camera_coord[:, :, 2:] + 1e-6)
    return abs_corners, homo_coord, thetas


def back_projection(bbox3d: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """Image-frame 3-D box states [N, 7] (image_x, image_y, z, w, h, l,
    alpha) -> camera-frame states [N, 7] (x3d, y3d, z, w, h, l, alpha)
    through P2 [3, 4] (reference networks/utils/utils.py:255-279)."""
    fx, fy, cx, cy, tx, ty = P2[0, 0], P2[1, 1], P2[0, 2], P2[1, 2], P2[0, 3], P2[1, 3]
    z3d = bbox3d[:, 2:3]
    x3d = (bbox3d[:, 0:1] * z3d - cx * z3d - tx) / fx
    y3d = (bbox3d[:, 1:2] * z3d - cy * z3d - ty) / fy
    return np.concatenate([x3d, y3d, bbox3d[:, 2:]], axis=1)


def corner_bbox_to_xyxy(corner_box: np.ndarray) -> np.ndarray:
    """[..., K, >=2] projected corners -> their enclosing [x1, y1, x2, y2]."""
    return np.concatenate([corner_box[..., 0:2].min(axis=-2),
                           corner_box[..., 0:2].max(axis=-2)], axis=-1)


def compound_annotation(labels, max_length: int, bbox2d, bbox_3d, obj_types) -> np.ndarray:
    """Pack each image's variable-length ground truth into a fixed
    [B, max_length, 12] array, rows [x1, y1, x2, y2, cls_index, cx, cy, z,
    w, h, l, alpha], empty rows -1 (cls_index -1 marks padding)."""
    num_3d = bbox_3d[0].shape[-1] if len(bbox_3d) > 0 and len(bbox_3d[0]) > 0 else 7
    annotations = np.full([len(labels), max_length, num_3d + 5], -1.0, dtype=np.float32)
    for i, label in enumerate(labels):
        for j, obj_type in enumerate(label):
            if j >= max_length:
                break
            annotations[i, j] = np.concatenate([
                bbox2d[i][j], [obj_types.index(obj_type)], bbox_3d[i][j]])
    return annotations


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
