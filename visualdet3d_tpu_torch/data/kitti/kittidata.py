"""KITTI label records (counterpart of ``KittiObj`` in
``visualdet3d_tpu/data/kitti/kittidata.py``): the fields the target
builders read. Reading image and calibration files comes with the KITTI
reader of a later slice."""
from __future__ import annotations

from typing import Optional

_LABEL_FIELDS = ('truncated', 'occluded', 'alpha',
                 'bbox_l', 'bbox_t', 'bbox_r', 'bbox_b',
                 'h', 'w', 'l', 'x', 'y', 'z', 'ry')


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
