"""Anchors with precomputed per-anchor 3D priors (counterpart of
``visualdet3d_tpu/models/heads/anchors.py``).

Anchors are host-side numpy constants made once per image shape; the
geometric "useful anchor" filter runs on tensors over the batch of
calibration matrices.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def generate_base_anchors(base_size: float, ratios: Sequence[float],
                          scales: Sequence[float]) -> np.ndarray:
    """Enumerate (ratio x scale) zero-centred anchors, scales fastest:
    anchor a = ratio_idx * num_scales + scale_idx; w*h = (size*scale)^2 and
    h/w = ratio."""
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    num = len(ratios) * len(scales)
    side = base_size * np.tile(scales, len(ratios))  # [A]
    ratio_rep = np.repeat(ratios, len(scales))  # [A]
    areas = side ** 2
    w = np.sqrt(areas / ratio_rep)
    h = w * ratio_rep
    anchors = np.zeros((num, 4), np.float64)
    anchors[:, 0] = -0.5 * w
    anchors[:, 1] = -0.5 * h
    anchors[:, 2] = 0.5 * w
    anchors[:, 3] = 0.5 * h
    return anchors


def shift_anchors(feat_shape: Tuple[int, int], stride: float,
                  base_anchors: np.ndarray) -> np.ndarray:
    """Tile base anchors over the (+0.5)*stride grid; locations outer,
    anchors inner, matching the head's [B, H*W*A, C] flatten."""
    fh, fw = feat_shape
    cx = (np.arange(fw) + 0.5) * stride
    cy = (np.arange(fh) + 0.5) * stride
    sx, sy = np.meshgrid(cx, cy)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)  # [K, 4]
    all_anchors = shifts[:, None, :] + base_anchors[None, :, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)


class Anchors:
    """Host-side anchor factory; ``get`` returns numpy constants."""

    def __init__(self,
                 preprocessed_path: str = '',
                 pyramid_levels: Sequence[int] = (4,),
                 strides: Sequence[float] = (16,),
                 sizes: Sequence[float] = (24,),
                 ratios: Sequence[float] = (0.5, 1.0),
                 scales: Sequence[float] = tuple(2 ** (i / 4.0) for i in range(16)),
                 read_config_file: bool = True,
                 obj_types: Sequence[str] = (),
                 filter_anchors: bool = True,
                 filter_y_threshold_min_max: Optional[Tuple[float, float]] = (-0.5, 1.8),
                 filter_x_threshold: Optional[float] = 40.0,
                 anchor_prior_channel: int = 6):
        self.pyramid_levels = list(pyramid_levels)
        self.strides = list(strides)
        self.sizes = list(sizes)
        self.ratios = np.asarray(ratios, np.float64)
        self.scales = np.asarray(scales, np.float64)
        self.filter_y_threshold_min_max = filter_y_threshold_min_max
        self.filter_x_threshold = filter_x_threshold
        self.anchor_prior_channel = anchor_prior_channel
        self.read_config_file = read_config_file
        self.obj_types = list(obj_types)

        if read_config_file:
            if not preprocessed_path:
                raise ValueError('need preprocessed_path to read anchor priors')
            save_dir = os.path.join(preprocessed_path, 'training')
            means, stds = [], []
            for t in self.obj_types:
                means.append(np.load(os.path.join(save_dir, f'anchor_mean_{t}.npy')))
                stds.append(np.load(os.path.join(save_dir, f'anchor_std_{t}.npy')))
            # [types, num_size_bins, num_ratio_bins, 6]
            self.anchors_mean_original = np.stack(means).astype(np.float32)
            self.anchors_std_original = np.stack(stds).astype(np.float32)

    @property
    def num_anchors(self) -> int:
        return len(self.pyramid_levels) * len(self.ratios) * len(self.scales)

    def anchors2indexes(self, anchors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Map each anchor box to its (size-bin, ratio-bin)."""
        sizes = np.sqrt((anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1]))
        size_bins = (np.array(self.sizes)[:, None] * self.scales[None, :]).reshape(-1)
        sizes_int = np.argmin(np.abs(sizes[None, :] - size_bins[:, None]), axis=0)
        ratio = (anchors[:, 3] - anchors[:, 1]) / (anchors[:, 2] - anchors[:, 0])
        ratio_int = np.argmin(np.abs(ratio[None, :] - self.ratios[:, None]), axis=0)
        return sizes_int, ratio_int

    def anchors_for_shape(self, image_hw: Tuple[int, int]) -> np.ndarray:
        """All anchors for an image shape: [N, 4] float32."""
        image_shape = np.array(image_hw[:2])
        parts = []
        for idx, level in enumerate(self.pyramid_levels):
            feat_shape = (image_shape + 2 ** level - 1) // (2 ** level)
            base = generate_base_anchors(self.sizes[idx], self.ratios, self.scales)
            parts.append(shift_anchors(tuple(feat_shape), self.strides[idx], base))
        return np.concatenate(parts, axis=0)

    def get(self, image_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
        """anchors [N, 4], centers_x/centers_y [N] and, with priors,
        anchor_mean_std [N, types, 6, 2]."""
        anchors = self.anchors_for_shape(image_hw)
        out = {
            'anchors': anchors,
            'centers_x': 0.5 * (anchors[:, 0] + anchors[:, 2]),
            'centers_y': 0.5 * (anchors[:, 1] + anchors[:, 3]),
        }
        if self.read_config_file:
            sizes_int, ratio_int = self.anchors2indexes(anchors)
            mean = self.anchors_mean_original[:, sizes_int, ratio_int]  # [types, N, 6]
            std = self.anchors_std_original[:, sizes_int, ratio_int]   # [types, N, 6]
            out['anchor_mean_std'] = np.stack([mean, std], axis=-1).transpose(1, 0, 2, 3)
        return out

    def useful_mask(self, anchor_pack: Dict[str, torch.Tensor], P2: torch.Tensor) -> torch.Tensor:
        """Keep anchors whose back-projected 3D center (with each class's
        prior z) lies in the road corridor.

        Args:
          anchor_pack: :meth:`get` as tensors on P2's device.
          P2: [B, 3, 4] calibrations.
        Returns:
          [B, N] bool.
        """
        if not self.read_config_file or self.filter_y_threshold_min_max is None:
            n = anchor_pack['anchors'].shape[0]
            return torch.ones((P2.shape[0], n), dtype=torch.bool, device=P2.device)
        anchors_z = anchor_pack['anchor_mean_std'][:, :, 0, 0].T  # [types, N]
        cx_img = anchor_pack['centers_x']  # [N]
        cy_img = anchor_pack['centers_y']
        fy = P2[:, 1:2, 1:2]  # [B, 1, 1]
        cy = P2[:, 1:2, 2:3]
        cx = P2[:, 0:1, 2:3]
        world_x = (cx_img[None, None, :] * anchors_z[None] - cx * anchors_z[None]) / fy
        world_y = (cy_img[None, None, :] * anchors_z[None] - cy * anchors_z[None]) / fy
        y_min, y_max = self.filter_y_threshold_min_max
        ok = (world_y > y_min) & (world_y < y_max) & (world_x.abs() < self.filter_x_threshold)
        return ok.any(dim=1)  # [B, N]
