"""Stereo KITTI datasets (counterpart of
``visualdet3d_tpu/data/kitti/dataset/stereo_dataset.py``): left and right
images with P2 and P3, the precomputed sparse disparity PNGs (uint16, /16,
read with the port's PNG reader) and the mirror rule: after
``RandomMirror`` swaps the eyes, |P2 tx| > |P3 tx| says that the disparity
ground truth comes from the P3 projection, mirrored.
"""
from __future__ import annotations

import copy
import os
import pickle

import numpy as np

from visualdet3d_tpu_torch import geometry
from visualdet3d_tpu_torch.data.augmentations import build_augmentator
from visualdet3d_tpu_torch.data.image_io import read_image, read_png
from visualdet3d_tpu_torch.data.kitti.dataset.mono_dataset import reproject_3d_boxes
from visualdet3d_tpu_torch.registry import DATASET_DICT


@DATASET_DICT.register_module
class KittiStereoDataset:
    def __init__(self, cfg, split='training'):
        preprocessed_path = cfg.path.preprocessed_path
        is_train = (split == 'training')
        imdb_file_path = os.path.join(preprocessed_path, split, 'imdb.pkl')
        with open(imdb_file_path, 'rb') as f:
            self.imdb = pickle.load(f)
        if is_train:
            self.transform = build_augmentator(cfg.data.train_augmentation)
        else:
            self.transform = build_augmentator(cfg.data.test_augmentation)
        self.is_train = is_train
        self.obj_types = list(cfg.obj_types)
        self.preprocessed_path = preprocessed_path

    def __len__(self):
        return len(self.imdb)

    def __getitem__(self, index):
        record = self.imdb[index]
        left_image = read_image(record['image_2_path'])
        right_image = read_image(record['image_3_path'])
        calib = record['calib']
        label = [copy.deepcopy(o) for o in record['label'] if o.type in self.obj_types]
        (left_t, right_t, P2, P3, label_t) = self.transform(
            left_image, right_image, calib['P2'].copy(), calib['P3'].copy(), label)
        bbox3d_state = np.zeros([len(label_t), 7], np.float32)
        if len(label_t) > 0:
            # the stereo dataset keeps the original alpha
            label_t, bbox3d_state = reproject_3d_boxes(
                P2, label_t, recompute_alpha=False, is_reproject=True)

        if self.is_train:
            if abs(P2[0, 3]) < abs(P3[0, 3]):  # not mirrored/swapped
                disp_path = os.path.join(self.preprocessed_path, 'training',
                                         'disp', 'P2%06d.png' % index)
                disparity = read_png(disp_path)
            else:  # mirrored: disparity from the P3 projection, flipped
                disp_path = os.path.join(self.preprocessed_path, 'training',
                                         'disp', 'P3%06d.png' % index)
                disparity = read_png(disp_path)
                disparity = disparity[:, ::-1]
            disparity = disparity / 16.0
        else:
            disparity = None

        bbox2d = np.array([[o.bbox_l, o.bbox_t, o.bbox_r, o.bbox_b]
                           for o in label_t], np.float32).reshape(-1, 4)
        return {
            'calib': [P2, P3],
            'image': [left_t, right_t],
            'label': [o.type for o in label_t],
            'bbox2d': bbox2d,
            'bbox3d': bbox3d_state,
            'original_shape': left_image.shape,
            'disparity': disparity,
            'original_P': calib['P2'].copy(),
        }

    @staticmethod
    def collate_fn(batch, obj_types=None, max_objects: int = 32):
        left = np.stack([item['image'][0] for item in batch]).astype(np.float32)
        right = np.stack([item['image'][1] for item in batch]).astype(np.float32)
        P2 = np.stack([item['calib'][0] for item in batch]).astype(np.float32)
        P3 = np.stack([item['calib'][1] for item in batch]).astype(np.float32)
        out = dict(left_images=left, right_images=right, P2=P2, P3=P3,
                   labels=[item['label'] for item in batch],
                   bbox2d=[item['bbox2d'] for item in batch],
                   bbox3d=[item['bbox3d'] for item in batch])
        if batch[0].get('disparity') is not None:
            out['disparity'] = np.stack(
                [item['disparity'] for item in batch]).astype(np.float32)
        if obj_types is not None:
            out['annotations'] = geometry.compound_annotation(
                out['labels'], max_objects, out['bbox2d'], out['bbox3d'], obj_types)
        return out


@DATASET_DICT.register_module
class KittiStereoTestDataset(KittiStereoDataset):
    """Label-free stereo test dataset."""

    def __init__(self, cfg, split='test'):
        preprocessed_path = cfg.path.preprocessed_path
        imdb_file_path = os.path.join(preprocessed_path, 'test', 'imdb.pkl')
        with open(imdb_file_path, 'rb') as f:
            self.imdb = pickle.load(f)
        self.transform = build_augmentator(cfg.data.test_augmentation)
        self.is_train = False
        self.obj_types = list(cfg.obj_types)
        self.preprocessed_path = preprocessed_path

    def __getitem__(self, index):
        record = self.imdb[index]
        left_image = read_image(record['image_2_path'])
        right_image = read_image(record['image_3_path'])
        calib = record['calib']
        left_t, right_t, P2, P3 = self.transform(
            left_image, right_image, calib['P2'].copy(), calib['P3'].copy())
        return {
            'calib': [P2, P3],
            'image': [left_t, right_t],
            'original_shape': left_image.shape,
            'original_P': calib['P2'].copy(),
        }

    @staticmethod
    def collate_fn(batch, obj_types=None, max_objects: int = 32):
        left = np.stack([item['image'][0] for item in batch]).astype(np.float32)
        right = np.stack([item['image'][1] for item in batch]).astype(np.float32)
        P2 = np.stack([item['calib'][0] for item in batch]).astype(np.float32)
        P3 = np.stack([item['calib'][1] for item in batch]).astype(np.float32)
        return dict(left_images=left, right_images=right, P2=P2, P3=P3)
