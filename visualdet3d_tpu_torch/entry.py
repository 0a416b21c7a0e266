"""Entry points of the port: the counterpart of ``__graft_entry__.entry()``.

``entry()`` returns ``(fn, example_args)``: YOLOStereo3D inference at the
KITTI benchmark resolution 288x1280 (ResNet-34 trunk with the s2d stem, the
CUDA correlation volumes, the concat volume, the pyramid, the 1408-channel
head, decode and NMS, all on the card). Weights are random, made from a
seed; the anchor priors are synthetic.

``build_km3d_system()`` is the KM3D system of ``configs/km3d.py`` (DLA-34,
the DCN neck on the CUDA deformable-conv kernel, ``head_features=256``) for
384x1280 images (``KM3D_IMAGE_HW``), random weights from a seed.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.ops.kernel_build import BUILD_DIR
from visualdet3d_tpu_torch.registry import DETECTOR_DICT
from visualdet3d_tpu_torch.testing import (
    km3d_detector_cfg, stereo3d_detector_cfg, write_synthetic_priors)

IMAGE_HW = (288, 1280)
KM3D_IMAGE_HW = (384, 1280)
KITTI_P2 = np.array([
    [721.5377, 0.0, 609.5593, 44.85728],
    [0.0, 721.5377, 72.854, 0.2163791],
    [0.0, 0.0, 1.0, 0.002745884],
], np.float32)


def build_system(depth: int = 34, device: Optional[Union[str, torch.device]] = None,
                 preprocessed: Optional[str] = None):
    """The benchmark ``Stereo3D`` (Car, Pedestrian) with random weights from
    seed 0 on ``device`` (the card unless the caller names another).
    Synthetic priors go to ``preprocessed``, by default inside the package's
    build directory."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers Stereo3D)

    device = resolve_device(device)
    if preprocessed is None:
        preprocessed = os.path.join(BUILD_DIR, 'priors')
    obj_types = ('Car', 'Pedestrian')
    write_synthetic_priors(preprocessed, obj_types, num_ratios=3)  # stereo ratios (0.5, 1, 2)
    cfg = stereo3d_detector_cfg(preprocessed, obj_types=obj_types, depth=depth)
    return DETECTOR_DICT[cfg.name](cfg, device=device)


def build_km3d_system(device: Optional[Union[str, torch.device]] = None):
    """The published KM3D (Car; DLA-34, ``head_features=256``, top-K 100)
    with random weights from seed 0 on ``device`` (the card unless the
    caller names another)."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers KM3D)

    device = resolve_device(device)
    cfg = km3d_detector_cfg()
    return DETECTOR_DICT[cfg.name](cfg, device=device)


def entry(device: Optional[Union[str, torch.device]] = None):
    """Flagship forward: YOLOStereo3D at 288x1280, depth 34, batch 1."""
    device = resolve_device(device)
    system = build_system(device=device)
    system.anchor_pack(IMAGE_HW)  # warm the anchor cache: fn is device work only

    def fn(left, right, P2):
        out = system.predict(left, right, P2, max_detections=32)
        return out['scores'], out['bboxes'], out['labels'], out['valid']

    left = torch.zeros((1, *IMAGE_HW, 3), device=device)
    right = torch.zeros((1, *IMAGE_HW, 3), device=device)
    P2 = torch.as_tensor(KITTI_P2, device=device)[None]
    return fn, (left, right, P2)
