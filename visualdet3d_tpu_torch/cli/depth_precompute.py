"""Precompute MonoDepth's per-pixel log-depth prior (counterpart of
``visualdet3d_tpu/cli/depth_precompute.py``; reference
scripts/depth_precompute.py:19-80): the per-pixel sums and counts of the
log ground-truth depth over the training set (read with the evaluation
transform, as the JAX CLI reads it: the ``'val'`` split argument), blended
with an analytic ground-plane prior (weight 1000 below the horizon, 10
above), saved as ``<preprocessed_path>/training/log_depth_sum.npy`` and
``log_depth_solid.npy``, which ``MonoDepth`` reads for its prior mean.

Usage: python -m visualdet3d_tpu_torch.cli.depth_precompute --config=configs/monodepth.py
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from visualdet3d_tpu_torch.config import cfg_from_file
from visualdet3d_tpu_torch.registry import DATASET_DICT


def compute_prior_map(w: int, h: int, K: np.ndarray, relative_elevation: float = 1.65):
    """The ground plane's log depth at each row below the horizon (log 75 m
    above it, clipped to [0, log 75]) times its weight, and the weights."""
    yy = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    fy = K[1, 1]
    cy = K[1, 2]
    depth = (fy * relative_elevation) / (yy - cy + 1e-9)
    prior = np.where(yy > cy, np.log(np.clip(depth, 1e-9, None)), np.log(75.0))
    prior = np.clip(prior, 0, np.log(75.0))
    num = np.where(yy > cy, 1000, 10).astype(np.int64)
    return prior * num, num


def precompute_depth_statistic(config: str) -> None:
    """Write the two prior files of ``config``'s training set (the last
    frame's K places the analytic prior)."""
    import visualdet3d_tpu_torch.data  # noqa: F401  (registers the datasets)
    cfg = cfg_from_file(config)
    dataset = DATASET_DICT[cfg.data.train_dataset](cfg, 'val')  # the evaluation transform
    save_dir = os.path.join(cfg.path.preprocessed_path, 'training')
    os.makedirs(save_dir, exist_ok=True)

    h, w = cfg.data.rgb_shape[0], cfg.data.rgb_shape[1]
    sum_data = np.zeros((h, w), np.float64)
    number_solid = np.zeros((h, w), np.int64)
    K = None
    for i in range(len(dataset)):
        item = dataset[i]
        sparse_depth = item['gt']
        mask = sparse_depth > 0
        number_solid[mask] += 1
        sum_data[mask] += np.log(sparse_depth[mask] + 1e-9)
        K = item['K']
        if (i + 1) % 100 == 0:
            print(f'depth prior {i + 1}/{len(dataset)}', end='\r')

    prior_map, weight_map = compute_prior_map(w, h, K)
    np.save(os.path.join(save_dir, 'log_depth_sum.npy'), sum_data + prior_map)
    np.save(os.path.join(save_dir, 'log_depth_solid.npy'), number_solid + weight_map)
    print('\ndepth prior precompute finished')


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='configs/monodepth.py')
    precompute_depth_statistic(parser.parse_args(argv).config)


if __name__ == '__main__':
    main()
