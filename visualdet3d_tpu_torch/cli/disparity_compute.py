"""Precompute the disparity ground truth of stereo training (counterpart
of ``visualdet3d_tpu/cli/disparity_compute.py``): per training frame, two
maps at the test augmentation's geometry, max-reduced over 4x4 blocks and
stored as uint16 x16 PNGs (``disp/P2%06d.png``, ``disp/P3%06d.png``),
which ``KittiStereoDataset`` reads. Either

* the point cloud (the default): the velodyne scan projected through the
  augmented P2 and P3; or
* ``--use_stereo_bm``: OpenCV's StereoBM (192 disparities, 25x25 window)
  on the de-normalised grey images (resized as ``cv2.resize`` resizes,
  bit for bit: ``cv_ops.exact_resize``), through the port's own block matcher
  (``ops/stereo_bm.py``: a CUDA kernel on the card, its plain version with
  ``--device cpu``): the left eye on (left, right), the right eye on the
  mirrored pair (right, left), kept in the mirrored frame as the JAX CLI
  keeps it; negative (filtered) values become 0.

Usage: python -m visualdet3d_tpu_torch.cli.disparity_compute --config=configs/stereo3d.py \
           [--use_stereo_bm] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
from copy import deepcopy

import numpy as np

import torch

from visualdet3d_tpu_torch.config import cfg_from_file
from visualdet3d_tpu_torch.data.augmentations import build_augmentator
from visualdet3d_tpu_torch.data.cv_ops import exact_resize, rgb_to_gray
from visualdet3d_tpu_torch.data.image_io import write_png
from visualdet3d_tpu_torch.data.kitti.kittidata import KittiData
from visualdet3d_tpu_torch.data.kitti.utils import generate_disparity_from_velo
from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.ops.stereo_bm import stereo_bm


def block_reduce_max(x: np.ndarray, k: int = 4) -> np.ndarray:
    h, w = x.shape
    h2, w2 = h - h % k, w - w % k
    return x[:h2, :w2].reshape(h2 // k, k, w2 // k, k).max(axis=(1, 3))


def denorm(image, rgb_mean, rgb_std) -> np.ndarray:
    """A normalised float image back to uint8, as the JAX CLI does it (the
    clip, then the cast, which truncates)."""
    out = (image * rgb_std + rgb_mean) * 255
    return np.clip(out, 0, 255).astype(np.uint8)


def stereo_bm_pair(gray_left: np.ndarray, gray_right: np.ndarray, device) -> tuple:
    """The StereoBM maps of both eyes, uint16 x16: the left eye's, and the
    right eye's on the mirrored pair (in the mirrored frame)."""
    left = torch.from_numpy(np.ascontiguousarray(gray_left)).to(device)
    right = torch.from_numpy(np.ascontiguousarray(gray_right)).to(device)
    maps = (stereo_bm(left, right), stereo_bm(right.flip(1), left.flip(1)))
    return tuple(m.clamp_min(0).cpu().numpy().astype(np.uint16) for m in maps)


def compute_disparity_for_split(cfg, index_names, data_root_dir, output_dict,
                                data_split='training', use_point_cloud=True, device=None):
    """The two maps of every frame of ``index_names``; StereoBM runs on
    ``device`` (the card unless the caller names another)."""
    disp_dir = os.path.join(cfg.path.preprocessed_path, data_split, 'disp')
    os.makedirs(disp_dir, exist_ok=True)
    preprocess = build_augmentator(cfg.data.test_augmentation)
    device = None if use_point_cloud else resolve_device(device)

    for i, index_name in enumerate(index_names):
        data_frame = KittiData(data_root_dir, index_name, output_dict)
        read = data_frame.read_data()
        calib, image, right_image, velo = read[0], read[1], read[2], read[-1]
        baseline = (calib.P2[0, 3] - calib.P3[0, 3]) / calib.P2[0, 0]
        with contextlib.nullcontext() if use_point_cloud else exact_resize():
            image_t, image_3, P2, P3 = preprocess(
                image.copy(), right_image.copy(), deepcopy(calib.P2), deepcopy(calib.P3))
        if use_point_cloud:
            maps = [generate_disparity_from_velo(
                velo[:, :3], image_t.shape[0], image_t.shape[1],
                calib.Tr_velo_to_cam, calib.R0_rect, P, baseline=baseline) for P in (P2, P3)]
        else:
            aug = cfg.data.augmentation
            maps = stereo_bm_pair(rgb_to_gray(denorm(image_t, aug.rgb_mean, aug.rgb_std)),
                                  rgb_to_gray(denorm(image_3, aug.rgb_mean, aug.rgb_std)),
                                  device)
        for name, disparity in zip(('P2', 'P3'), maps):
            write_png(os.path.join(disp_dir, '%s%06d.png' % (name, i)),
                      block_reduce_max(disparity, 4))
        if (i + 1) % 100 == 0:
            print(f'{data_split} disparity {i + 1}/{len(index_names)}', end='\r')
    print(f'\n{data_split} split finished precomputing disparity')


def run(cfg, use_stereo_bm: bool = False, device=None) -> None:
    """The training split's disparity maps of ``cfg``."""
    output_dict = {'calib': True, 'image': True, 'image_3': True,
                   'label': False, 'velodyne': not use_stereo_bm}
    with open(cfg.data.train_split_file) as f:
        train_names = [line.strip() for line in f if line.strip()]
    compute_disparity_for_split(cfg, train_names, cfg.path.data_path, output_dict, 'training',
                                use_point_cloud=not use_stereo_bm, device=device)
    print('Preprocessing finished')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='configs/stereo3d.py')
    parser.add_argument('--use_stereo_bm', action='store_true',
                        help='StereoBM on the image pair in place of the point cloud')
    parser.add_argument('--device', default=None,
                        help="where StereoBM runs: the card unless 'cpu' is given")
    args = parser.parse_args(argv)
    run(cfg_from_file(args.config), args.use_stereo_bm, args.device)


if __name__ == '__main__':
    main()
