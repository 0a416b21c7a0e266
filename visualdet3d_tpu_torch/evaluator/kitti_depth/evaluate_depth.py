"""KITTI depth-prediction metrics (devkit translation), vectorised numpy
(counterpart of ``visualdet3d_tpu/evaluator/kitti_depth/evaluate_depth.py``;
the 16-bit PNGs are read by the port's ``data/image_io.py``).

reference: visualDet3D/evaluator/kitti_depth_prediction/evaluate_depth.py:
6-117 — 9 metrics (MAE, RMSE, inverse MAE/RMSE, log MAE/RMSE, scale-invariant
log, abs/squared relative) over valid (gt > 0.01) pixels; the per-pixel numba
loop becomes masked array reductions.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from visualdet3d_tpu_torch.data.image_io import read_png

METRIC_NAMES = [
    'mae', 'rmse', 'inverse mae', 'inverse rmse', 'log mae', 'log rmse',
    'scale invariant log', 'abs relative', 'squared relative',
]


def compute_errors(image_gt: np.ndarray, image_pred: np.ndarray) -> np.ndarray:
    """9-vector of errors over valid pixels (reference :6-81)."""
    mask = image_gt > 0.01
    gt = image_gt[mask]
    pred = np.clip(image_pred[mask], 1e-9, None)
    n = max(gt.size, 1)

    d = np.abs(pred - gt)
    d_inv = np.abs(1.0 / gt - 1.0 / pred)
    d_log = np.abs(np.log(pred) - np.log(gt))
    log_sum = np.sum(np.log(gt) - np.log(pred))

    errors = np.zeros(9)
    errors[0] = d.mean() if gt.size else 0.0
    errors[1] = np.sqrt((d ** 2).sum() / n)
    errors[2] = d_inv.sum() / n
    errors[3] = np.sqrt((d_inv ** 2).sum() / n)
    errors[4] = d_log.sum() / n
    normalized_sq_log = (d_log ** 2).sum() / n
    errors[5] = np.sqrt(normalized_sq_log)
    errors[6] = np.sqrt(max(normalized_sq_log - (log_sum ** 2) / (n ** 2), 0.0))
    errors[7] = (d / gt).sum() / n
    errors[8] = ((d ** 2) / (gt ** 2)).sum() / n
    return errors


def evaluate_depth(label_path: str, result_path: str,
                   scale: float = 256.0) -> List[str]:
    """Compare uint16/256 PNG predictions against GT (reference :83-117)."""
    gt_list = sorted(os.path.join(label_path, g) for g in os.listdir(label_path)
                     if g.endswith('.png'))
    result_list = sorted(os.path.join(result_path, r)
                         for r in os.listdir(result_path) if r.endswith('.png'))
    if len(gt_list) != len(result_list):
        print(f'Notice: gt_list {len(gt_list)} != result_list {len(result_list)}')
    errors = []
    for gt_file, pred_file in zip(gt_list, result_list):
        image_gt = read_png(gt_file) / scale
        image_pred = read_png(pred_file) / scale
        errors.append(compute_errors(image_gt, image_pred))
    errors = np.array(errors)
    return [f'mean {METRIC_NAMES[i]} : {np.mean(errors[:, i])}\n'
            for i in range(len(METRIC_NAMES))]
