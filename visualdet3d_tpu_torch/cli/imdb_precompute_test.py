"""Precompute the image database of the label-free KITTI test split
(counterpart of ``visualdet3d_tpu/cli/imdb_precompute_test.py``): every
frame of ``cfg.path.test_path`` that has a ``calib/*.txt``, in sorted
order, as a record dict(index, image_2_path, image_3_path, velodyne_path,
calib{P2, P3, R0_rect, Tr_velo_to_cam}, label=[]) in
``<preprocessed_path>/test/imdb.pkl``, which ``KittiStereoTestDataset``
and ``KittiMonoTestDataset`` read (the eval CLI's ``--split_to_test
test``). Only the calibration files are read.

Usage: python -m visualdet3d_tpu_torch.cli.imdb_precompute_test --config=configs/stereo3d.py
"""
from __future__ import annotations

import argparse
import os
import pickle

from visualdet3d_tpu_torch.config import cfg_from_file
from visualdet3d_tpu_torch.data.kitti.kittidata import KittiData


def run(cfg) -> list:
    """Write the test split's imdb of ``cfg``; returns its records."""
    test_root = cfg.path.test_path
    names = sorted(f[:-4] for f in os.listdir(os.path.join(test_root, 'calib'))
                   if f.endswith('.txt'))
    save_dir = os.path.join(cfg.path.preprocessed_path, 'test')
    os.makedirs(save_dir, exist_ok=True)

    frames = []
    for i, name in enumerate(names):
        data_frame = KittiData(test_root, name, {'calib': True, 'image': False,
                                                 'label': False, 'velodyne': False})
        calib = data_frame.read_data()[0]
        frames.append(dict(
            index=name,
            image_2_path=data_frame.image2_path,
            image_3_path=data_frame.image3_path,
            velodyne_path=data_frame.velodyne_path,
            calib=dict(P2=calib.P2, P3=calib.P3, R0_rect=calib.R0_rect,
                       Tr_velo_to_cam=calib.Tr_velo_to_cam),
            label=[],
        ))
        if (i + 1) % 500 == 0:
            print(f'test imdb {i + 1}/{len(names)}', end='\r')

    with open(os.path.join(save_dir, 'imdb.pkl'), 'wb') as f:
        pickle.dump(frames, f)
    print(f'\ntest split finished precomputing ({len(frames)} frames)')
    return frames


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='configs/stereo3d.py')
    run(cfg_from_file(parser.parse_args(argv).config))


if __name__ == '__main__':
    main()
