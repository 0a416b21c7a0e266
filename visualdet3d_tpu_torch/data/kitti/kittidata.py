"""KITTI raw file I/O (counterpart of
``visualdet3d_tpu/data/kitti/kittidata.py``): calibration, labels, images
(through the port's own PNG reader, ``data/image_io.py``) and velodyne
scans. ``KittiData`` is the per-frame bundle, its ``output_dict`` choosing
which files ``read_data`` loads."""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from visualdet3d_tpu_torch.data.image_io import read_image

_LABEL_FIELDS = ('truncated', 'occluded', 'alpha',
                 'bbox_l', 'bbox_t', 'bbox_r', 'bbox_b',
                 'h', 'w', 'l', 'x', 'y', 'z', 'ry')


def read_pc_from_bin(path: str) -> np.ndarray:
    """Velodyne scan [N, 4] (x, y, z, reflectance), lidar frame."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


class KittiCalib:
    """KITTI calibration file. After ``read_calib_file()``: P2/P3 [3, 4],
    R0_rect [4, 4], Tr_velo_to_cam [4, 4] (float64)."""

    def __init__(self, calib_path: Optional[str] = None):
        self.path = calib_path
        self.data = None
        self.P2: Optional[np.ndarray] = None
        self.P3: Optional[np.ndarray] = None
        self.R0_rect: Optional[np.ndarray] = None
        self.Tr_velo_to_cam: Optional[np.ndarray] = None

    def read_calib_file(self) -> 'KittiCalib':
        data = {}
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line or ':' not in line:
                    continue
                key, vals = line.split(':', 1)
                data[key] = np.array([float(v) for v in vals.split()])
        self.data = data
        self.P2 = data['P2'].reshape(3, 4)
        self.P3 = data['P3'].reshape(3, 4)
        r0 = np.eye(4)
        r0[:3, :3] = data['R0_rect'].reshape(3, 3)
        self.R0_rect = r0
        tr = np.eye(4)
        tr[:3, :] = data['Tr_velo_to_cam'].reshape(3, 4)
        self.Tr_velo_to_cam = tr
        return self

    def lidar2leftcam(self, pts: np.ndarray) -> np.ndarray:
        from visualdet3d_tpu_torch.data.kitti.utils import lidar_to_leftcam
        return lidar_to_leftcam(pts, self.Tr_velo_to_cam, self.R0_rect)

    def leftcam2lidar(self, pts: np.ndarray) -> np.ndarray:
        from visualdet3d_tpu_torch.data.kitti.utils import leftcam_to_lidar
        return leftcam_to_lidar(pts, self.Tr_velo_to_cam, self.R0_rect)

    def leftcam2imgplane(self, pts: np.ndarray) -> np.ndarray:
        from visualdet3d_tpu_torch.data.kitti.utils import leftcam_to_image_plane
        return leftcam_to_image_plane(pts, self.P2)


class KittiObj:
    """One KITTI object row.

    Field order in the txt: type truncated occluded alpha bbox(l t r b)
    dimensions(h w l) location(x y z) ry [score]. KITTI stores the vertical
    dimension first (h, w, l) and ``y`` is the *bottom* center.
    """

    def __init__(self, s: Optional[str] = None):
        self.type = None
        for f in _LABEL_FIELDS:
            setattr(self, f, None)
        self.score = None
        if s is None:
            return
        parts = s.split()
        if len(parts) not in (15, 16):
            raise ValueError(f'malformed KITTI label row ({len(parts)} fields): {s!r}')
        self.type = parts[0]
        for f, v in zip(_LABEL_FIELDS, parts[1:15]):
            setattr(self, f, float(v))
        if len(parts) == 16:
            self.score = float(parts[15])

    def __str__(self):
        base = (f'{self.type} {self.truncated:.2f} {int(self.occluded)} '
                f'{self.alpha:.2f} {self.bbox_l:.2f} {self.bbox_t:.2f} '
                f'{self.bbox_r:.2f} {self.bbox_b:.2f} {self.h:.2f} {self.w:.2f} '
                f'{self.l:.2f} {self.x:.2f} {self.y:.2f} {self.z:.2f} {self.ry:.2f}')
        if self.score is not None:
            base += f' {self.score:.2f}'
        return base


class KittiLabel:
    """All objects of one frame."""

    def __init__(self, label_path: Optional[str] = None):
        self.path = label_path
        self.data: Optional[List[KittiObj]] = None

    def read_label_file(self, no_dontcare: bool = True) -> 'KittiLabel':
        self.data = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.data.append(KittiObj(line))
        if no_dontcare:
            self.data = [o for o in self.data if o.type != 'DontCare']
        return self

    def __str__(self):
        return '\n'.join(str(o) for o in (self.data or []))


class KittiData:
    """Per-frame bundle; ``output_dict`` selects which files ``read_data``
    loads."""

    def __init__(self, root_dir: str, idx: str, output_dict=None):
        self.calib_path = os.path.join(root_dir, 'calib', idx + '.txt')
        self.image2_path = os.path.join(root_dir, 'image_2', idx + '.png')
        self.image3_path = os.path.join(root_dir, 'image_3', idx + '.png')
        self.label2_path = os.path.join(root_dir, 'label_2', idx + '.txt')
        self.velodyne_path = os.path.join(root_dir, 'velodyne', idx + '.bin')
        self.output_dict = output_dict or {
            'calib': True, 'image': True, 'image_3': False,
            'label': True, 'velodyne': True,
        }

    def read_data(self):
        """(calib, image, label, pc), or (calib, image, image_3, label, pc)
        when ``output_dict['image_3']``; what is not asked for is None."""
        od = self.output_dict
        calib = KittiCalib(self.calib_path).read_calib_file() if od.get('calib') else None
        image = read_image(self.image2_path) if od.get('image') else None
        label = KittiLabel(self.label2_path).read_label_file() if od.get('label') else None
        pc = read_pc_from_bin(self.velodyne_path) if od.get('velodyne') else None
        if od.get('image_3'):
            image_3 = read_image(self.image3_path)
            return calib, image, image_3, label, pc
        return calib, image, label, pc
