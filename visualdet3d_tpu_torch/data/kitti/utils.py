"""KITTI geometry and raster utilities in numpy (counterpart of
``visualdet3d_tpu/data/kitti/utils.py``): lidar <-> camera transforms, the
sparse disparity and depth maps rasterised from a velodyne scan (one
scatter, the last point in scan order winning) and the KITTI result-file
writer."""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _homogeneous(pts: np.ndarray) -> np.ndarray:
    return np.concatenate([pts, np.ones((pts.shape[0], 1), pts.dtype)], axis=1)


def lidar_to_leftcam(pts: np.ndarray, Tr_velo_to_cam: np.ndarray,
                     R0_rect: np.ndarray) -> np.ndarray:
    """[N, 3] lidar -> left camera frame."""
    pts_cam = (R0_rect @ Tr_velo_to_cam @ _homogeneous(pts[:, :3]).T).T
    return pts_cam[:, :3]


def leftcam_to_lidar(pts: np.ndarray, Tr_velo_to_cam: np.ndarray,
                     R0_rect: np.ndarray) -> np.ndarray:
    """[N, 3] left camera -> lidar frame."""
    inv = np.linalg.inv
    pts_lidar = (inv(Tr_velo_to_cam) @ inv(R0_rect) @ _homogeneous(pts[:, :3]).T).T
    return pts_lidar[:, :3]


def leftcam_to_image_plane(pts: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """[N, 3] camera frame -> [N, 2] pixels."""
    pix = (P2 @ _homogeneous(pts[:, :3]).T).T
    return pix[:, :2] / (pix[:, 2:3] + 1e-6)


def _project_and_rasterize(pc_velo, height, width, Tr_velo_to_cam, R0_rect, P2):
    """Projection and the in-view filter: integer pixel coordinates and
    depths of the points in front (x > 2 m) that land inside the image."""
    pts_cam = lidar_to_leftcam(pc_velo[:, :3], Tr_velo_to_cam, R0_rect)
    pts_2d = leftcam_to_image_plane(pts_cam, P2)
    fov = ((pts_2d[:, 0] >= 0) & (pts_2d[:, 0] < width - 1) &
           (pts_2d[:, 1] >= 0) & (pts_2d[:, 1] < height - 1) &
           (pc_velo[:, 0] > 2))
    uv = pts_2d[fov].astype(np.int32)
    depth = pts_cam[fov, 2]
    return uv, depth


def generate_disparity_from_velo(pc_velo: np.ndarray, height: int, width: int,
                                 Tr_velo_to_cam: np.ndarray, R0_rect: np.ndarray,
                                 P2: np.ndarray, baseline: float = 0.54) -> np.ndarray:
    """Sparse disparity ground truth from a velodyne scan: uint16, x16
    fixed point, 0 where no point lands."""
    uv, depth = _project_and_rasterize(pc_velo, height, width, Tr_velo_to_cam, R0_rect, P2)
    depth_map = np.full((height, width), 1e9)
    depth_map.reshape(-1)[uv[:, 1] * width + uv[:, 0]] = depth  # the last point wins
    disp = (P2[0, 0] * baseline) / depth_map * 16
    return disp.astype(np.uint16)


def generate_depth_from_velo(pc_velo: np.ndarray, height: int, width: int,
                             Tr_velo_to_cam: np.ndarray, R0_rect: np.ndarray,
                             P2: np.ndarray,
                             base_depth: Optional[np.ndarray] = None) -> np.ndarray:
    """Sparse depth map: 0 (or ``base_depth``) where no point lands."""
    uv, depth = _project_and_rasterize(pc_velo, height, width, Tr_velo_to_cam, R0_rect, P2)
    depth_map = np.zeros((height, width)) if base_depth is None else base_depth
    depth_map.reshape(-1)[uv[:, 1] * width + uv[:, 0]] = depth
    return depth_map


def write_result_to_file(base_result_path: str, index: int, scores,
                         bbox_2d: np.ndarray,
                         bbox_3d_state_3d: Optional[np.ndarray] = None,
                         thetas: Optional[np.ndarray] = None,
                         obj_types: List[str] = ('Car', 'Pedestrian', 'Cyclist'),
                         threshold: float = 0.4) -> None:
    """Write one frame's detections in the KITTI submission format.

    ``bbox_3d_state_3d`` rows are [x, y (centre), z, w, h, l, alpha]; KITTI
    wants the *bottom* centre, so y += h / 2 before writing. The file's
    column order is (h, w, l) = (state[4], state[3], state[5]).
    """
    name = '%06d' % index
    lines = []
    n = len(bbox_2d)
    if bbox_3d_state_3d is None:
        bbox_3d_state_3d = np.full((n, 7), -1.0)
        bbox_3d_state_3d[:, 0:3] = -1000
        bbox_3d_state_3d[:, 6] = -10
    else:
        bbox_3d_state_3d = np.array(bbox_3d_state_3d, dtype=np.float64, copy=True)
        bbox_3d_state_3d[:, 1] += 0.5 * bbox_3d_state_3d[:, 4]
    if thetas is None:
        thetas = np.full(n, -10.0)
    for i in range(n):
        if len(scores) == 0 or scores[i] < threshold:
            continue
        b = bbox_2d[i]
        s = bbox_3d_state_3d[i]
        lines.append(
            '{} -1 -1 {:.6f} {:.6f} {:.6f} {:.6f} {:.6f} {:.6f} {:.6f} {:.6f} '
            '{:.6f} {:.6f} {:.6f} {:.6f} {} \n'.format(
                obj_types[i], s[6], b[0], b[1], b[2], b[3],
                s[4], s[3], s[5], s[0], s[1], s[2], thetas[i], scores[i]))
    with open(os.path.join(base_result_path, name + '.txt'), 'w') as f:
        f.write(''.join(lines))
