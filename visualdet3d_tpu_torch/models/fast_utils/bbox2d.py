"""2D box numpy utilities (counterpart of
``visualdet3d_tpu/models/fast_utils/bbox2d.py``; reference
networks/lib/fast_utils/bbox2d.py, numba-JIT there; plain vectorised numpy
here)."""
from __future__ import annotations

import numpy as np


def bbox2d_area(boxes: np.ndarray) -> np.ndarray:
    """[N, 4] -> [N] areas."""
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def iou_2d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Aligned IoU of boxes_a[i] vs boxes_b[i]: [N, 4] x [N, 4] -> [N]."""
    ix1 = np.maximum(boxes_a[:, 0], boxes_b[:, 0])
    iy1 = np.maximum(boxes_a[:, 1], boxes_b[:, 1])
    ix2 = np.minimum(boxes_a[:, 2], boxes_b[:, 2])
    iy2 = np.minimum(boxes_a[:, 3], boxes_b[:, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    union = bbox2d_area(boxes_a) + bbox2d_area(boxes_b) - inter
    return inter / np.maximum(union, 1e-12)
