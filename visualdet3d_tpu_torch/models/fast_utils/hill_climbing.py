"""Test-time hill-climbing yaw refinement, vectorised over detections
(counterpart of ``visualdet3d_tpu/models/fast_utils/hill_climbing.py``;
numpy on the host).

reference: networks/lib/fast_utils/hill_climbing.py:7-123 — per-detection
numba loops refining yaw so the re-projected 3D box best matches the
predicted 2D box. Here *all* detections climb simultaneously: each carries
its own (theta, step, best-iou) state, each sweep projects the +/-step
candidates for every detection at once, and detections halve their steps
independently — same fixed point as the reference's sequential loop.
Applied when ``test_cfg.post_optimization`` is set
(reference detection_3d_head.py:294-308, 396-398).
"""
from __future__ import annotations

import numpy as np

from visualdet3d_tpu_torch.geometry import convert_alpha_to_rot, convert_rot_to_alpha
from visualdet3d_tpu_torch.models.fast_utils.bbox2d import iou_2d
from visualdet3d_tpu_torch.models.fast_utils.bbox3d import project_3d_corners

# image-frame clamp used by the reference's projection test
# (hill_climbing.py:111-117; tuned to the 288x1280 network input)
_CLIP_W, _CLIP_H = 1280, 288


def _projection_iou(p2, box_2d, x3d, y3d, z3d, w3d, h3d, l3d, theta):
    """IoU between predicted 2D boxes and re-projected 3D boxes; all [N]."""
    verts, _ = project_3d_corners(p2, x3d, y3d, z3d, w3d, h3d, l3d, theta)
    x1 = np.clip(verts[:, :, 0].min(axis=1), 0, None)
    y1 = np.clip(verts[:, :, 1].min(axis=1), 0, None)
    x2 = np.clip(verts[:, :, 0].max(axis=1), None, _CLIP_W)
    y2 = np.clip(verts[:, :, 1].max(axis=1), None, _CLIP_H)
    proj_boxes = np.stack([x1, y1, x2, y2], axis=1)
    return iou_2d(box_2d, proj_boxes)


def hill_climb_batch(p2, box_2d, x3d, y3d, z3d, w3d, h3d, l3d, theta,
                     step_r_init: float = 0.3, r_lim: float = 0.01,
                     min_ol_dif: float = 0.0):
    """Vectorised hill climb over theta; returns (theta [N], best_iou [N])."""
    theta = theta.astype(np.float64).copy()
    step = np.full_like(theta, step_r_init)
    best = _projection_iou(p2, box_2d, x3d, y3d, z3d, w3d, h3d, l3d, theta)
    active = step > r_lim
    while active.any():
        ol_neg = _projection_iou(p2, box_2d, x3d, y3d, z3d, w3d, h3d, l3d,
                                 theta - step)
        ol_pos = _projection_iou(p2, box_2d, x3d, y3d, z3d, w3d, h3d, l3d,
                                 theta + step)
        pos_better = (ol_pos - best > min_ol_dif) & (ol_pos > ol_neg)
        neg_better = (ol_neg - best > min_ol_dif) & ~pos_better
        invalid = ~(pos_better | neg_better)
        theta = np.where(active & pos_better, theta + step, theta)
        theta = np.where(active & neg_better, theta - step, theta)
        best = np.where(active & pos_better, ol_pos, best)
        best = np.where(active & neg_better, ol_neg, best)
        step = np.where(active & invalid, step * 0.5, step)
        active = step > r_lim
    # the reference wraps with the LITERAL 3.14 (subtracting 3.14*2) on the
    # high side and +2*pi on the low side (hill_climbing.py:80-81); replicate
    # exactly — it shifts thetas in (3.14, pi] by 0.0032 vs a true mod-2pi
    while (theta > 3.14).any():
        theta = np.where(theta > 3.14, theta - 3.14 * 2, theta)
    while (theta < -3.14).any():
        theta = np.where(theta < -3.14, theta + 2 * np.pi, theta)
    return theta, best


def _refine_alpha(box2d, state, cx, P2):
    """The hill climb of every row of ``state`` ([N, 7]: x, y, z, w, h, l,
    alpha) against ``box2d`` [N, 4]; ``cx`` [N] is each row's image-space
    centre for the alpha<->theta conversion. Returns the refined alphas."""
    p2 = np.eye(4)
    p2[:3] = np.asarray(P2)[:3]
    theta0 = convert_alpha_to_rot(state[:, 6], cx, P2)
    theta, _ = hill_climb_batch(p2, box2d, *state[:, :6].T, theta0,
                                step_r_init=0.4, r_lim=0.01)
    return convert_rot_to_alpha(theta, cx, P2)


def post_opt(bbox_2d, bbox3d_state_3d, P2, cx, cy):
    """Refine one detection (reference hill_climbing.py:7-23 signature):
    its centre is back-projected from (cx, cy) at its depth, as the
    reference does, then climbed as :func:`post_optimization` climbs."""
    out = np.asarray(bbox3d_state_3d, np.float64).reshape(-1).copy()
    p2 = np.eye(4)
    p2[:3] = np.asarray(P2)[:3]
    z = out[2]
    row = out.copy()
    row[:3] = (np.linalg.inv(p2) @ np.array([cx * z, cy * z, z, 1.0]))[:3]
    out[6] = _refine_alpha(np.asarray(bbox_2d, np.float64).reshape(1, 4), row[None],
                           np.array([cx]), P2)[0]
    return out


def post_optimization(bbox_2d: np.ndarray, bbox_3d_state_3d: np.ndarray,
                      P2: np.ndarray, obj_names, min_z: float = 3.0,
                      refined_type: str = 'Car') -> np.ndarray:
    """Batch entry used by the evaluator: refine alpha of all Car detections
    with z > 3 (reference _post_process, detection_3d_head.py:294-308)."""
    state = np.asarray(bbox_3d_state_3d, np.float64).copy()
    n = state.shape[0]
    if n == 0:
        return state
    refine = np.array([(obj_names[i] == refined_type) and state[i, 2] > min_z
                       for i in range(n)])
    if not refine.any():
        return state
    idx = np.where(refine)[0]
    sub = state[idx]
    # image-space centers for the alpha<->theta conversion
    centers = np.einsum('ij,nj->ni', np.asarray(P2)[:3],
                        np.concatenate([sub[:, :3], np.ones((len(idx), 1))], 1))
    state[idx, 6] = _refine_alpha(np.asarray(bbox_2d, np.float64)[idx], sub,
                                  centers[:, 0] / centers[:, 2], P2)
    return state
