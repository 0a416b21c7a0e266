"""Registered evaluation pipelines (counterpart of
``visualdet3d_tpu/pipelines/evaluators.py``; reference
visualDet3D/networks/pipelines/evaluators.py:19-146): run a split frame by
frame at batch 1, write KITTI-format results in the original camera, call
the offline evaluator.

Decode and NMS run on the system's device inside ``predict``; each frame's
kept boxes come to the host once, for the back-projection, the optional
hill-climbing post-optimisation, the rescale to the original camera and
the file I/O. ``evaluate_kitti_depth`` writes each frame's depth as a
16-bit PNG at the original size (``data/cv_ops.resize``, OpenCV's 16-bit
arithmetic) and runs the KITTI depth evaluator on them.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional, Sized

import numpy as np

from visualdet3d_tpu_torch import geometry
from visualdet3d_tpu_torch.data import cv_ops
from visualdet3d_tpu_torch.data.image_io import write_png
from visualdet3d_tpu_torch.data.kitti.utils import write_result_to_file
from visualdet3d_tpu_torch.registry import PIPELINE_DICT


def _fresh_dir(path: str):
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)


def rescale_boxes_to_original(bbox_2d: np.ndarray, P2: np.ndarray,
                              original_P: np.ndarray) -> np.ndarray:
    """Undo the augmentation scaling/cropping using the calibration pair
    (reference evaluators.py:119-129)."""
    scale_x = original_P[0, 0] / P2[0, 0]
    scale_y = original_P[1, 1] / P2[1, 1]
    shift_left = original_P[0, 2] / scale_x - P2[0, 2]
    shift_top = original_P[1, 2] / scale_y - P2[1, 2]
    out = bbox_2d.copy()
    out[:, 0:4:2] += shift_left
    out[:, 1:4:2] += shift_top
    out[:, 0:4:2] *= scale_x
    out[:, 1:4:2] *= scale_y
    return out


def test_one(cfg, index, dataset, test_fn, result_path, post_opt_fn=None,
             times: Optional[dict] = None):
    """Single-frame inference + KITTI txt writing (reference
    evaluators.py:101-146). ``times``, if given, gets the ms of this
    frame's item (``load_ms``), inference (``frame_ms``: ``test_fn``, the
    copy to the host included) and post-optimisation (``post_opt_ms``)
    appended to its lists."""
    t0 = time.perf_counter()
    data = dataset[index]
    P2 = data['calib'][0] if isinstance(data['calib'], list) else data['calib']
    collated = dataset.collate_fn([data])
    t1 = time.perf_counter()
    scores, bbox, obj_names = test_fn(collated)
    t2 = time.perf_counter()
    if times is not None:
        times.setdefault('load_ms', []).append((t1 - t0) * 1e3)
        times.setdefault('frame_ms', []).append((t2 - t1) * 1e3)
    scores = np.asarray(scores)
    bbox = np.asarray(bbox)
    if bbox.ndim == 1:  # zero-detection frames keep an explicit [0, C] shape
        bbox = bbox.reshape(len(scores), 11 if bbox.size == 0 else -1)
    bbox_2d = bbox[:, 0:4]
    if bbox.shape[1] > 4:
        bbox_3d_state = bbox[:, 4:]  # [cx, cy, z, w, h, l, alpha]
        bbox_3d_state_3d = geometry.back_projection(bbox_3d_state, P2)
        if post_opt_fn is not None and len(scores) > 0:
            t3 = time.perf_counter()
            bbox_3d_state_3d = post_opt_fn(bbox_2d, bbox_3d_state_3d, P2, obj_names)
            if times is not None:
                times.setdefault('post_opt_ms', []).append((time.perf_counter() - t3) * 1e3)
        if len(scores) > 0:
            _, _, thetas = geometry.project_bbox3d(
                bbox_3d_state_3d[:, :7].astype(np.float32), P2.astype(np.float32))
        else:
            thetas = np.zeros((0,))
        bbox_2d = rescale_boxes_to_original(bbox_2d, P2, data['original_P'])
        write_result_to_file(result_path, index, scores, bbox_2d,
                             np.asarray(bbox_3d_state_3d), thetas, obj_names)
    else:
        original_height = data['original_shape'][0]
        height = collated['images'].shape[1]
        aug_cfg = cfg.data.augmentation
        if aug_cfg.get('crop_top') is not None:
            crop_top = aug_cfg.crop_top
        else:
            crop_top = max(original_height - aug_cfg.crop_top_height, 0)
        scale_2d = (original_height - crop_top) / height
        bbox_2d = bbox_2d * scale_2d
        bbox_2d[:, 1:4:2] += crop_top
        write_result_to_file(result_path, index, scores, bbox_2d,
                             obj_types=obj_names)


def write_eval_stats(cfg, record: dict) -> None:
    """Appends ``record`` as one JSON line to ``<log_path>/eval_stats.jsonl``
    (the eval CLI's and the train CLI's evaluations)."""
    os.makedirs(cfg.path.log_path, exist_ok=True)
    with open(os.path.join(cfg.path.log_path, 'eval_stats.jsonl'), 'a') as f:
        f.write(json.dumps(record) + '\n')


def split_file(cfg, split: str) -> str:
    """The split file listing the frames of ``split``, in dataset order."""
    return cfg.data.train_split_file if split == 'training' else cfg.data.val_split_file


@PIPELINE_DICT.register_module
def evaluate_kitti_obj(cfg, system, dataset_val: Sized, writer, epoch_num: int,
                       result_path_split='validation', stats: Optional[dict] = None):
    """reference evaluators.py:65-99: every frame of ``dataset_val`` through
    ``cfg.trainer.test_func`` (and ``hill_climbing.post_optimization`` when
    ``test_cfg.post_optimization``), the result txts under
    ``<preprocessed_path>/<split>/data``, then the KITTI object evaluator
    against ``<data_path>/label_2`` for the frames of the split's file.
    Returns the report per class (None for the test set). ``stats``, if
    given, gets the per-frame ms lists of :func:`test_one` and the
    evaluator's seconds (``evaluator_s``)."""
    result_path = os.path.join(cfg.path.preprocessed_path, result_path_split, 'data')
    _fresh_dir(result_path)
    test_fn = PIPELINE_DICT[cfg.trainer.test_func](system)

    post_opt_fn = None
    if cfg.detector.head.test_cfg.get('post_optimization', False):
        from visualdet3d_tpu_torch.models.fast_utils import hill_climbing
        post_opt_fn = hill_climbing.post_optimization

    times = {} if stats is None else stats
    for index in range(len(dataset_val)):
        test_one(cfg, index, dataset_val, test_fn, result_path, post_opt_fn=post_opt_fn,
                 times=times)
        if (index + 1) % 100 == 0:
            print(f'eval {index + 1}/{len(dataset_val)}', end='\r')

    if cfg.get('is_running_test_set', False):
        print('Finish evaluation.')
        return None
    from visualdet3d_tpu_torch.evaluator.kitti_object.evaluate import evaluate
    t0 = time.perf_counter()
    result_texts = evaluate(
        label_path=os.path.join(cfg.path.data_path, 'label_2'),
        result_path=result_path,
        label_split_file=split_file(cfg, result_path_split),
        current_classes=[i for i in range(len(cfg.obj_types))])
    times['evaluator_s'] = time.perf_counter() - t0
    for class_index, result_text in enumerate(result_texts):
        if writer is not None:
            writer.add_text(f'validation result {class_index}',
                            result_text.replace(' ', '&nbsp;').replace('\n', '  \n'),
                            epoch_num + 1)
        print(result_text)
    return result_texts


def depth_png(depth: np.ndarray, original_hw) -> np.ndarray:
    """A predicted depth map [h, w] (metres, float32) as the uint16 image
    ``evaluate_kitti_depth`` writes (reference evaluators.py:19-63): depth
    x 256 truncated to uint16, the top edge row repeated up to the original
    height, resized to the original size (bilinear, OpenCV's 16-bit
    arithmetic), zeros set to 1."""
    depth_uint16 = (np.asarray(depth, np.float32) * 256).astype(np.uint16)
    h, w = int(original_hw[0]), int(original_hw[1])
    height_to_pad = h - depth_uint16.shape[0]
    if height_to_pad > 0:
        depth_uint16 = np.pad(depth_uint16, [(height_to_pad, 0), (0, 0)], mode='edge')
    depth_uint16 = cv_ops.resize(depth_uint16, (w, h))
    depth_uint16[depth_uint16 == 0] = 1
    return depth_uint16


@PIPELINE_DICT.register_module
def evaluate_kitti_depth(cfg, system, dataset_val: Sized, writer, epoch_num: int,
                         result_path_split='validation', stats: Optional[dict] = None):
    """reference evaluators.py:19-63: every frame of ``dataset_val`` through
    ``cfg.trainer.test_func`` (``test_mono_depth``) at batch 1, its depth
    written as ``<preprocessed_path>/<split>/data/%010d.png``
    (:func:`depth_png`), then the KITTI depth evaluator against
    ``<validation_path>/groundtruth_depth``. Returns the report lines (None
    for the test set). ``stats``, if given, gets the ms of each frame's
    item (``load_ms``), inference with the copy to the host (``frame_ms``)
    and PNG (``write_ms``), and the evaluator's seconds (``evaluator_s``)."""
    result_path = os.path.join(cfg.path.preprocessed_path, result_path_split, 'data')
    _fresh_dir(result_path)
    test_fn = PIPELINE_DICT[cfg.trainer.test_func](system)
    times = {} if stats is None else stats
    for index in range(len(dataset_val)):
        t0 = time.perf_counter()
        data = dataset_val[index]
        collated = dataset_val.collate_fn([data])
        t1 = time.perf_counter()
        depth = test_fn(collated)['target'][0, ..., 0].float().cpu().numpy()
        t2 = time.perf_counter()
        write_png(os.path.join(result_path, '%010d.png' % index),
                  depth_png(depth, data['original_shape']))
        t3 = time.perf_counter()
        for key, ms in (('load_ms', t1 - t0), ('frame_ms', t2 - t1), ('write_ms', t3 - t2)):
            times.setdefault(key, []).append(ms * 1e3)
    if cfg.get('is_running_test_set', False):
        print('Finish evaluation.')
        return None
    from visualdet3d_tpu_torch.evaluator.kitti_depth.evaluate_depth import evaluate_depth
    t0 = time.perf_counter()
    result_texts = evaluate_depth(
        label_path=os.path.join(cfg.path.validation_path, 'groundtruth_depth'),
        result_path=result_path)
    times['evaluator_s'] = time.perf_counter() - t0
    for index, result_text in enumerate(result_texts):
        if writer is not None:
            writer.add_text(f'validation result {index}',
                            result_text.replace(' ', '&nbsp;').replace('\n', '  \n'),
                            epoch_num + 1)
        print(result_text, end='')
    return result_texts
