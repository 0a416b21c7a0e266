"""Precompute the sparse disparity ground truth of stereo training
(counterpart of ``visualdet3d_tpu/cli/disparity_compute.py``, its point
cloud path): per training frame, the velodyne scan projected through the
augmented P2 and P3, max-reduced over 4x4 blocks and stored as uint16 x16
PNGs (``disp/P2%06d.png``, ``disp/P3%06d.png``), which
``KittiStereoDataset`` reads.

The JAX CLI's ``--use_point_cloud`` is ``store_true`` with default True, so
its StereoBM path is unreachable from the command line; here
``compute_disparity_for_split(..., use_point_cloud=False)`` raises.

Usage: python -m visualdet3d_tpu_torch.cli.disparity_compute --config=configs/stereo3d.py
"""
from __future__ import annotations

import argparse
import os
from copy import deepcopy

import numpy as np

from visualdet3d_tpu_torch.config import cfg_from_file
from visualdet3d_tpu_torch.data.augmentations import build_augmentator
from visualdet3d_tpu_torch.data.image_io import write_png
from visualdet3d_tpu_torch.data.kitti.kittidata import KittiData
from visualdet3d_tpu_torch.data.kitti.utils import generate_disparity_from_velo


def block_reduce_max(x: np.ndarray, k: int = 4) -> np.ndarray:
    h, w = x.shape
    h2, w2 = h - h % k, w - w % k
    return x[:h2, :w2].reshape(h2 // k, k, w2 // k, k).max(axis=(1, 3))


def compute_disparity_for_split(cfg, index_names, data_root_dir, output_dict,
                                data_split='training', use_point_cloud=True):
    if not use_point_cloud:
        raise NotImplementedError(
            'the StereoBM disparity is not ported (the JAX CLI cannot reach it either); '
            'see ROADMAP.md Queue A, A7 (the tools)')
    disp_dir = os.path.join(cfg.path.preprocessed_path, data_split, 'disp')
    os.makedirs(disp_dir, exist_ok=True)
    preprocess = build_augmentator(cfg.data.test_augmentation)

    for i, index_name in enumerate(index_names):
        data_frame = KittiData(data_root_dir, index_name, output_dict)
        calib, image, right_image, _, velo = data_frame.read_data()
        baseline = (calib.P2[0, 3] - calib.P3[0, 3]) / calib.P2[0, 0]
        image_t, _, P2, P3 = preprocess(
            image.copy(), right_image.copy(), deepcopy(calib.P2), deepcopy(calib.P3))
        for name, P in (('P2', P2), ('P3', P3)):
            disparity = generate_disparity_from_velo(
                velo[:, :3], image_t.shape[0], image_t.shape[1],
                calib.Tr_velo_to_cam, calib.R0_rect, P, baseline=baseline)
            write_png(os.path.join(disp_dir, '%s%06d.png' % (name, i)),
                      block_reduce_max(disparity, 4))
        if (i + 1) % 100 == 0:
            print(f'{data_split} disparity {i + 1}/{len(index_names)}', end='\r')
    print(f'\n{data_split} split finished precomputing disparity')


def run(cfg) -> None:
    """The training split's disparity maps of ``cfg``."""
    output_dict = {'calib': True, 'image': True, 'image_3': True,
                   'label': False, 'velodyne': True}
    with open(cfg.data.train_split_file) as f:
        train_names = [line.strip() for line in f if line.strip()]
    compute_disparity_for_split(cfg, train_names, cfg.path.data_path, output_dict, 'training')
    print('Preprocessing finished')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='configs/stereo3d.py')
    run(cfg_from_file(parser.parse_args(argv).config))


if __name__ == '__main__':
    main()
