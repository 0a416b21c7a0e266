"""Precompute the image database (``imdb.pkl``) and the per-anchor 3-D
priors (counterpart of ``visualdet3d_tpu/cli/imdb_precompute_3d.py``).

For every training frame: the labels are filtered (occlusion below
``max_occlusion``, z above ``min_z``), the global [z, sin 2a, cos 2a, w, h,
l] moments accumulated, the test-time augmentation applied to get the
network-input geometry, the anchors matched to the ground-truth 2-D boxes
by IoU, and per-(class, size bin, ratio bin) moments of [z, sin 2a, cos 2a]
saved as ``anchor_mean_{type}.npy`` / ``anchor_std_{type}.npy`` (bins with
fewer than 10 samples get mean -100 and std 1e10, so that the runtime prior
filter drops them). The imdb is a pickled list of records: dict(index,
image_2_path, image_3_path, velodyne_path, calib{P2, P3, R0_rect,
Tr_velo_to_cam}, label=[KittiObj, ...]).

The priors are computed when ``cfg.anchor_prior`` says so; without that
key, when the detector's head has anchors (``head.anchors_cfg``): KM3D and
MonoFlex have none, so their imdb needs no priors (the JAX CLI raises on
their configs).

Usage: python -m visualdet3d_tpu_torch.cli.imdb_precompute_3d --config=configs/yolo3d_gac.py
"""
from __future__ import annotations

import argparse
import os
import pickle
from copy import deepcopy

import numpy as np
import torch

from visualdet3d_tpu_torch.config import cfg_from_file
from visualdet3d_tpu_torch.data.augmentations import build_augmentator
from visualdet3d_tpu_torch.data.kitti.kittidata import KittiData
from visualdet3d_tpu_torch.geometry import calc_iou
from visualdet3d_tpu_torch.models.heads.anchors import Anchors
from visualdet3d_tpu_torch.utils.timer import Timer


def process_train_val_file(cfg):
    with open(cfg.data.train_split_file) as f:
        train_lines = [line.strip() for line in f if line.strip()]
    with open(cfg.data.val_split_file) as f:
        val_lines = [line.strip() for line in f if line.strip()]
    return train_lines, val_lines


def read_one_split(cfg, index_names, data_root_dir, output_dict,
                   data_split='training', time_display_inter=100):
    save_dir = os.path.join(cfg.path.preprocessed_path, data_split)
    os.makedirs(save_dir, exist_ok=True)
    if data_split == 'training':
        os.makedirs(os.path.join(save_dir, 'disp'), exist_ok=True)

    n_frames = len(index_names)
    frames = [None] * n_frames
    timer = Timer()
    num_types = len(cfg.obj_types)

    anchor_prior = cfg.get('anchor_prior', 'anchors_cfg' in cfg.detector.head)
    total_objects = [0] * num_types
    total_usable_objects = [0] * num_types
    if anchor_prior:
        anchors_cfg = dict(cfg.detector.head.anchors_cfg)
        anchors_cfg.pop('obj_types', None)
        anchor_manager = Anchors(cfg.path.preprocessed_path,
                                 read_config_file=False, **anchors_cfg)
        preprocess = build_augmentator(cfg.data.test_augmentation)
        len_scale = len(anchor_manager.scales)
        len_ratios = len(anchor_manager.ratios)
        len_level = len(anchor_manager.pyramid_levels)

        examine = np.zeros([num_types, len_level * len_scale, len_ratios])
        sums = np.zeros([num_types, len_level * len_scale, len_ratios, 3])
        squared = np.zeros([num_types, len_level * len_scale, len_ratios, 3], dtype=np.float64)
        uniform_sum = np.zeros((num_types, 6), np.float64)
        uniform_square = np.zeros((num_types, 6), np.float64)
        fg_iou = cfg.detector.head.loss_cfg.fg_iou_threshold

    max_occlusion = cfg.data.get('max_occlusion', 2)
    min_z = cfg.data.get('min_z', 3)

    for i, index_name in enumerate(index_names):
        data_frame = KittiData(data_root_dir, index_name, output_dict)
        read = data_frame.read_data()
        calib, image, label = read[0], read[1], read[-2]

        if data_split == 'training':
            kept = [obj for obj in label.data
                    if obj.type in cfg.obj_types and obj.occluded < max_occlusion
                    and obj.z > min_z]
        else:
            kept = [obj for obj in label.data if obj.type in cfg.obj_types]

        frames[i] = dict(
            index=index_name,
            image_2_path=data_frame.image2_path,
            image_3_path=data_frame.image3_path,
            velodyne_path=data_frame.velodyne_path,
            calib=dict(P2=calib.P2, P3=calib.P3, R0_rect=calib.R0_rect,
                       Tr_velo_to_cam=calib.Tr_velo_to_cam),
            label=kept,
        )

        if data_split == 'training' and anchor_prior:
            for j, t in enumerate(cfg.obj_types):
                objs = [o for o in kept if o.type == t]
                total_objects[j] += len(objs)
                if objs:
                    data = np.array([[o.z, np.sin(2 * o.alpha), np.cos(2 * o.alpha),
                                      o.w, o.h, o.l] for o in objs])
                    uniform_sum[j] += data.sum(axis=0)
                    uniform_square[j] += (data ** 2).sum(axis=0)

            proc_image, P2, proc_label = preprocess(
                image.copy(), p2=deepcopy(calib.P2), labels=deepcopy(kept))
            if len(proc_label) > 0:
                anchors = anchor_manager.anchors_for_shape(proc_image.shape[:2])
                for j, t in enumerate(cfg.obj_types):
                    objs = [o for o in proc_label if o.type == t]
                    if not objs:
                        continue
                    bbox2d = np.array([[o.bbox_l, o.bbox_t, o.bbox_r, o.bbox_b]
                                       for o in objs], np.float32)
                    bbox3d = np.array([[o.x, o.y, o.z, np.sin(2 * o.alpha),
                                        np.cos(2 * o.alpha)] for o in objs], np.float32)
                    ious = calc_iou(torch.from_numpy(anchors),
                                    torch.from_numpy(bbox2d)).numpy()  # [N, K]
                    iou_max_gt = ious.max(axis=0)  # per GT
                    total_usable_objects[j] += int((iou_max_gt > fg_iou).sum())

                    iou_max_anchor = ious.max(axis=1)
                    iou_argmax_anchor = ious.argmax(axis=1)
                    pos = iou_max_anchor > fg_iou
                    pos_gt_3d = bbox3d[iou_argmax_anchor[pos]]
                    used_anchors = anchors[pos]
                    sizes_int, ratio_int = anchor_manager.anchors2indexes(used_anchors)
                    np.add.at(examine[j], (sizes_int, ratio_int), 1)
                    np.add.at(sums[j], (sizes_int, ratio_int), pos_gt_3d[:, 2:5])
                    np.add.at(squared[j], (sizes_int, ratio_int), pos_gt_3d[:, 2:5] ** 2)

        if (i + 1) % time_display_inter == 0:
            print(f'{data_split} {i + 1}/{n_frames} eta:{timer.compute_eta(i + 1, n_frames)} '
                  f'total:{total_objects} usable:{total_usable_objects}', end='\r')

    if data_split == 'training' and anchor_prior:
        for j, t in enumerate(cfg.obj_types):
            global_mean = uniform_sum[j] / max(total_objects[j], 1)
            global_var = np.sqrt(np.maximum(
                uniform_square[j] / max(total_objects[j], 1) - global_mean ** 2, 0))

            avg = sums[j] / (examine[j][:, :, None] + 1e-8)
            ex2 = squared[j] / (examine[j][:, :, None] + 1e-8)
            std = np.sqrt(np.maximum(ex2 - avg ** 2, 0))

            # starve low-population bins: the runtime prior filter (mean z
            # <= 0) drops them
            avg[examine[j] < 10, :] = -100
            std[examine[j] < 10, :] = 1e10
            avg[np.isnan(std)] = -100
            std[np.isnan(std)] = 1e10
            avg[std < 1e-3] = -100
            std[std < 1e-3] = 1e10

            whl_avg = np.ones([avg.shape[0], avg.shape[1], 3]) * global_mean[3:6]
            whl_std = np.ones([avg.shape[0], avg.shape[1], 3]) * global_var[3:6]
            avg = np.concatenate([avg, whl_avg], axis=2)
            std = np.concatenate([std, whl_std], axis=2)
            np.save(os.path.join(save_dir, f'anchor_mean_{t}.npy'), avg)
            np.save(os.path.join(save_dir, f'anchor_std_{t}.npy'), std)

    with open(os.path.join(save_dir, 'imdb.pkl'), 'wb') as f:
        pickle.dump(frames, f)
    print(f'\n{data_split} split finished precomputing ({n_frames} frames)')


def run(cfg) -> None:
    """The training split (with priors) and the validation split of ``cfg``."""
    data_root_dir = cfg.path.data_path
    output_dict = {'calib': True, 'image': True, 'label': True, 'velodyne': False}
    train_names, val_names = process_train_val_file(cfg)
    read_one_split(cfg, train_names, data_root_dir, output_dict, 'training')
    output_dict = {'calib': True, 'image': False, 'label': True, 'velodyne': False}
    read_one_split(cfg, val_names, data_root_dir, output_dict, 'validation')
    print('Preprocessing finished')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='configs/yolo3d_gac.py')
    run(cfg_from_file(parser.parse_args(argv).config))


if __name__ == '__main__':
    main()
