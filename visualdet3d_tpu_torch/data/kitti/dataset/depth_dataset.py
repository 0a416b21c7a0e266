"""KITTI depth-prediction datasets (counterpart of
``visualdet3d_tpu/data/kitti/dataset/depth_dataset.py``; reference
visualDet3D/data/kitti/dataset/depth_mono_dataset.py:30-213).

``KittiDepthMonoDataset`` walks the KITTI raw tree (``<date>/<drive>_sync/
image_02|03/data``, each date's ``calib_cam_to_cam.txt``) and the
depth-annotated tree (``<drive>_sync/proj_depth/groundtruth/image_02|03``),
keeps the frames that have both, and in training reads the left or the
right eye at random (numpy's global generator, as the JAX package), with
its P_rect. ``KittiDepthMonoValTestDataset`` reads the
``val_selection_cropped`` / test trees (``image``, ``intrinsics``). Depth
maps are 16-bit PNGs / 256, read by the port's ``data/image_io.py``.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from visualdet3d_tpu_torch.data.augmentations import build_augmentator
from visualdet3d_tpu_torch.data.image_io import read_png
from visualdet3d_tpu_torch.data.kitti.kittidata import read_image
from visualdet3d_tpu_torch.registry import DATASET_DICT


def read_depth(path: str) -> np.ndarray:
    """A 16-bit depth PNG / 256 -> metric depth [H, W] float32 (0: no return)."""
    return (read_png(path) / 256.0).astype(np.float32)


def read_K_from_depth_prediction(file: str) -> np.ndarray:
    """The 3x3 intrinsics of a depth-selection ``intrinsics`` file (its first
    line, nine numbers)."""
    with open(file) as f:
        data = f.readlines()[0].split(' ')
        return np.array([float(v) for v in data[:9]]).reshape(3, 3)


def read_P23_from_sequence(file: str):
    """P_rect_02 / P_rect_03 [3, 4] from a calib_cam_to_cam.txt."""
    P2 = P3 = None
    with open(file) as f:
        for line in f:
            if line.startswith('P_rect_02'):
                P2 = np.array([float(x) for x in line.split(' ')[1:13]]).reshape(3, 4)
            if line.startswith('P_rect_03'):
                P3 = np.array([float(x) for x in line.split(' ')[1:13]]).reshape(3, 4)
    assert P2 is not None and P3 is not None, f'missing P_rect in {file}'
    return P2, P3


def read_T_from_sequence(file: str) -> np.ndarray:
    """The velodyne-to-camera extrinsics [4, 4] from a calib_velo_to_cam.txt."""
    R = T = None
    with open(file) as f:
        for line in f:
            if line.startswith('R:'):
                R = np.array([float(x) for x in line.split(' ')[1:10]]).reshape(3, 3)
            if line.startswith('T:'):
                T = np.array([float(x) for x in line.split(' ')[1:4]]).reshape(3, 1)
    assert R is not None and T is not None, f'missing R/T in {file}'
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3:4] = T
    return out


def _p34(P: np.ndarray) -> np.ndarray:
    """[K | 0] of a projection matrix, float32."""
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = P[:3, :3]
    return out


@DATASET_DICT.register_module
class KittiDepthMonoDataset:
    """Raw images with projected ground-truth depth (reference
    depth_mono_dataset.py:81-168). ``split`` other than 'training' is the
    evaluation mode: the left eye and ``cfg.data.test_augmentation``."""

    def __init__(self, cfg, split='training'):
        raw_path = cfg.path.raw_path
        depth_paths = cfg.path.depth_path if isinstance(cfg.path.depth_path, list) \
            else [cfg.path.depth_path]
        self.is_eval = split != 'training'

        raw_sequences = {}
        for date_time in os.listdir(raw_path):
            date_dir = os.path.join(raw_path, date_time)
            if not os.path.isdir(date_dir):
                continue
            P2, P3 = read_P23_from_sequence(os.path.join(date_dir, 'calib_cam_to_cam.txt'))
            for sequence in os.listdir(date_dir):
                if sequence.endswith('.txt'):
                    continue
                raw_sequences[sequence] = dict(P2=P2, P3=P3, date_time=date_time)

        self.imdb: List[dict] = []
        for depth_path in depth_paths:
            for sequence in sorted(os.listdir(depth_path)):
                if sequence not in raw_sequences:
                    continue
                seq = raw_sequences[sequence]
                gt_path = os.path.join(depth_path, sequence, 'proj_depth', 'groundtruth')
                left_gt = os.path.join(gt_path, 'image_02')
                right_gt = os.path.join(gt_path, 'image_03')
                left_img = os.path.join(raw_path, seq['date_time'], sequence, 'image_02', 'data')
                right_img = os.path.join(raw_path, seq['date_time'], sequence, 'image_03', 'data')
                names = sorted(set(os.listdir(left_gt)) & set(os.listdir(left_img)))
                self.imdb += [dict(
                    image_2_file=os.path.join(left_img, n),
                    image_3_file=os.path.join(right_img, n),
                    gt_2_file=os.path.join(left_gt, n),
                    gt_3_file=os.path.join(right_gt, n),
                    P2=seq['P2'].copy(), P3=seq['P3'].copy(),
                ) for n in names]

        aug = cfg.data.train_augmentation if not self.is_eval else cfg.data.test_augmentation
        self.transform = build_augmentator(aug)

    def __len__(self):
        return len(self.imdb)

    def __getitem__(self, index):
        obj = self.imdb[index]
        if self.is_eval or np.random.rand() < 0.5:
            image = read_image(obj['image_2_file'])
            gt = read_depth(obj['gt_2_file'])
            P = obj['P2']
        else:
            image = read_image(obj['image_3_file'])
            gt = read_depth(obj['gt_3_file'])
            P = obj['P3']
        transformed_image, P_new, gt = self.transform(image, p2=P.copy(), image_gt=gt)
        return {'K': P_new[0:3, 0:3].copy(), 'P': _p34(P_new), 'image': transformed_image,
                'gt': gt, 'original_shape': image.shape}

    @staticmethod
    def collate_fn(batch, obj_types=None, max_objects: int = 32):
        """dict(images [B, H, W, 3], P2 [B, 3, 4], gts [B, H, W] float32, K
        list); ``obj_types`` and ``max_objects`` are the detection
        datasets' arguments, unused."""
        images = np.stack([item['image'] for item in batch]).astype(np.float32)
        P2 = np.stack([item['P'] for item in batch]).astype(np.float32)
        gts = np.stack([item['gt'] for item in batch]).astype(np.float32)
        return dict(images=images, P2=P2, gts=gts, K=[item['K'] for item in batch])


@DATASET_DICT.register_module
class KittiDepthMonoValTestDataset:
    """The depth-selection validation or test tree (reference
    depth_mono_dataset.py:170-213): ``<cfg.path.<split>_path>/image`` and
    ``intrinsics``, matched in sorted order."""

    def __init__(self, cfg, split='validation'):
        base_path = cfg.path[split + '_path']
        self.transform = build_augmentator(cfg.data.test_augmentation)
        image_dir = os.path.join(base_path, 'image')
        intrinsic_dir = os.path.join(base_path, 'intrinsics')
        image_list = sorted(os.listdir(image_dir))
        K_list = sorted(os.listdir(intrinsic_dir))
        self.imdb = [dict(
            image_file=os.path.join(image_dir, image_list[i]),
            K=read_K_from_depth_prediction(os.path.join(intrinsic_dir, K_list[i])),
        ) for i in range(len(image_list))]

    def __len__(self):
        return len(self.imdb)

    def __getitem__(self, index):
        obj = self.imdb[index]
        image = read_image(obj['image_file'])
        transformed_image = self.transform(image)[0]
        K34 = np.zeros((3, 4), np.float32)
        K34[:, :3] = obj['K']
        return {'K': obj['K'].copy(), 'P': K34, 'image': transformed_image,
                'original_shape': image.shape}

    @staticmethod
    def collate_fn(batch, obj_types=None, max_objects: int = 32):
        images = np.stack([item['image'] for item in batch]).astype(np.float32)
        P2 = np.stack([item['P'] for item in batch]).astype(np.float32)
        return dict(images=images, P2=P2, K=[item['K'] for item in batch])
