"""Vectorised 3D corner projection for the hill-climbing post-optimiser
(counterpart of ``visualdet3d_tpu/models/fast_utils/bbox3d.py``).

reference: networks/lib/fast_utils/bbox3d.py:19-80 (project_3d), batched over
detections instead of numba-JIT per box.
"""
from __future__ import annotations

import numpy as np


def project_3d_corners(p2: np.ndarray, x3d, y3d, z3d, w3d, h3d, l3d, ry3d):
    """Project N 3D boxes to image vertices.

    Args:
      p2: [4, 4] (or [3, 4]) projection.
      x3d..ry3d: [N] arrays (box center + size + yaw).
    Returns:
      verts: [N, 8, 2] image coordinates; corners: [N, 8, 3] camera frame.
    """
    x3d, y3d, z3d = np.atleast_1d(x3d), np.atleast_1d(y3d), np.atleast_1d(z3d)
    w3d, h3d, l3d = np.atleast_1d(w3d), np.atleast_1d(h3d), np.atleast_1d(l3d)
    ry3d = np.atleast_1d(ry3d)
    n = x3d.shape[0]

    # unit corner pattern (reference bbox3d.py:47-53), centred
    ux = np.array([0, 1, 1, 1, 1, 0, 0, 0], np.float64) - 0.5
    uy = np.array([0, 0, 1, 1, 0, 0, 1, 1], np.float64) - 0.5
    uz = np.array([0, 0, 0, 1, 1, 1, 1, 0], np.float64) - 0.5

    xc = ux[None, :] * l3d[:, None]
    yc = uy[None, :] * h3d[:, None]
    zc = uz[None, :] * w3d[:, None]

    cos, sin = np.cos(ry3d), np.sin(ry3d)
    rx = cos[:, None] * xc + sin[:, None] * zc
    rz = -sin[:, None] * xc + cos[:, None] * zc
    corners = np.stack([rx + x3d[:, None], yc + y3d[:, None],
                        rz + z3d[:, None]], axis=-1)  # [N, 8, 3]

    homog = np.concatenate([corners, np.ones((n, 8, 1))], axis=-1)
    proj = np.einsum('ij,nkj->nki', p2[:3], homog)
    verts = proj[..., :2] / np.maximum(proj[..., 2:3], 1e-9)
    return verts, corners
