"""Monocular KITTI datasets (counterpart of
``visualdet3d_tpu/data/kitti/dataset/mono_dataset.py``): the precomputed
imdb, the calibration-aware augmentations, the 3-D boxes projected again
into consistent 2-D boxes after them (``reproject_3d_boxes``), and the
training set doubled with the right camera's images (P3) as extra mono
samples. Collation gives fixed-shape NHWC batches with a fixed
``max_objects`` pad of the annotations.
"""
from __future__ import annotations

import copy
import os
import pickle
from typing import List, Tuple

import numpy as np

from visualdet3d_tpu_torch import geometry
from visualdet3d_tpu_torch.data.augmentations import build_augmentator
from visualdet3d_tpu_torch.data.kitti.kittidata import KittiObj, read_image
from visualdet3d_tpu_torch.registry import DATASET_DICT


def reproject_3d_boxes(P2: np.ndarray, labels: List[KittiObj],
                       recompute_alpha: bool = True,
                       is_reproject: bool = True) -> Tuple[List[KittiObj], np.ndarray]:
    """Re-derive each object's 2D box + image-frame 3D state from its 3D box
    under the (augmented) calibration P2.

    Returns (labels, bbox3d_state [N, 7] = [img_cx, img_cy, z, w, h, l, alpha]),
    where (img_cx, img_cy) is the projected 3D *center* (KITTI y is the bottom
    face, hence the y - h/2 shift).

    The stereo dataset skips the alpha recompute.
    """
    n = len(labels)
    bbox3d_state = np.zeros([n, 7], np.float32)
    if n == 0:
        return labels, bbox3d_state
    if recompute_alpha:
        for obj in labels:
            obj.alpha = float(geometry.theta2alpha_3d(obj.ry, obj.x, obj.z, P2))
    box7 = np.array([[obj.x, obj.y - 0.5 * obj.h, obj.z,
                      obj.w, obj.h, obj.l, obj.alpha] for obj in labels],
                    np.float32)
    _, homo_corner, _ = geometry.project_bbox3d(box7, P2.astype(np.float32))
    centers_h = (P2 @ np.concatenate(
        [box7[:, :3], np.ones((n, 1), np.float32)], axis=1).T).T  # [N, 3]
    bbox3d_state[:, 0] = centers_h[:, 0] / centers_h[:, 2]
    bbox3d_state[:, 1] = centers_h[:, 1] / centers_h[:, 2]
    bbox3d_state[:, 2] = centers_h[:, 2]
    bbox3d_state[:, 3:] = box7[:, 3:]

    bbox2d = geometry.corner_bbox_to_xyxy(np.asarray(homo_corner))
    if is_reproject:
        for i, obj in enumerate(labels):
            obj.bbox_l, obj.bbox_t, obj.bbox_r, obj.bbox_b = [
                float(v) for v in bbox2d[i]]
    return labels, bbox3d_state


@DATASET_DICT.register_module
class KittiMonoDataset:
    """Training/validation mono dataset over a precomputed imdb."""

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
        self.use_right_image = cfg.data.get('use_right_image', True) if 'data' in cfg else True
        self.is_reproject = cfg.data.get('is_reproject', True) if 'data' in cfg else True

    def __len__(self):
        if self.is_train and self.use_right_image:
            return len(self.imdb) * 2
        return len(self.imdb)

    def _load_record(self, index):
        record = self.imdb[index % len(self.imdb)]
        use_right = index >= len(self.imdb)
        if use_right:
            image = read_image(record['image_3_path'])
            # P3 plays the role of P2 for right-camera mono samples; the 3D
            # box state (cx, cy, z, whl, alpha) transfers unchanged
            P2 = record['calib']['P3'].copy()
        else:
            image = read_image(record['image_2_path'])
            P2 = record['calib']['P2'].copy()
        return record, image, P2

    def __getitem__(self, index):
        record, image, P2 = self._load_record(index)
        label = [copy.deepcopy(o) for o in record['label'] if o.type in self.obj_types]
        transformed_image, transformed_P2, transformed_label = self.transform(
            image, p2=P2.copy(), labels=label)
        bbox3d_state = np.zeros([len(transformed_label), 7], np.float32)
        if len(transformed_label) > 0:
            transformed_label, bbox3d_state = reproject_3d_boxes(
                transformed_P2, transformed_label, recompute_alpha=True,
                is_reproject=self.is_reproject)
        bbox2d = np.array([[o.bbox_l, o.bbox_t, o.bbox_r, o.bbox_b]
                           for o in transformed_label], np.float32).reshape(-1, 4)
        return {
            'calib': transformed_P2,
            'image': transformed_image,
            'label': [o.type for o in transformed_label],
            'bbox2d': bbox2d,
            'bbox3d': bbox3d_state,
            'original_shape': image.shape,
            'original_P': record['calib']['P2'].copy(),
        }

    @staticmethod
    def collate_fn(batch, obj_types=None, max_objects: int = 32):
        """Fixed-shape NHWC collation with compound annotations."""
        images = np.stack([item['image'] for item in batch]).astype(np.float32)
        P2 = np.stack([item['calib'] for item in batch]).astype(np.float32)
        out = dict(images=images, P2=P2,
                   labels=[item['label'] for item in batch],
                   bbox2d=[item['bbox2d'] for item in batch],
                   bbox3d=[item['bbox3d'] for item in batch])
        if obj_types is not None:
            out['annotations'] = geometry.compound_annotation(
                out['labels'], max_objects, out['bbox2d'], out['bbox3d'], obj_types)
        return out


@DATASET_DICT.register_module
class NuscMonoDataset(KittiMonoDataset):
    """Nuscenes-converted mono dataset: no right-image doubling."""

    def __len__(self):
        return len(self.imdb)


@DATASET_DICT.register_module
class KittiMonoTestDataset(KittiMonoDataset):
    """Label-free test dataset."""

    def __init__(self, cfg, split='test'):
        preprocessed_path = cfg.path.preprocessed_path
        imdb_file_path = os.path.join(preprocessed_path, 'test', 'imdb.pkl')
        self.transform = build_augmentator(cfg.data.test_augmentation)
        with open(imdb_file_path, 'rb') as f:
            self.imdb = pickle.load(f)
        self.is_train = False
        self.obj_types = list(cfg.obj_types)
        self.use_right_image = False
        self.is_reproject = True

    def __getitem__(self, index):
        record = self.imdb[index % len(self.imdb)]
        image = read_image(record['image_2_path'])
        P2 = record['calib']['P2'].copy()
        transformed_image, transformed_P2 = self.transform(image, p2=P2)
        return {
            'calib': transformed_P2,
            'image': transformed_image,
            'original_shape': image.shape,
            'original_P': record['calib']['P2'].copy(),
        }

    @staticmethod
    def collate_fn(batch, obj_types=None, max_objects: int = 32):
        images = np.stack([item['image'] for item in batch]).astype(np.float32)
        P2 = np.stack([item['calib'] for item in batch]).astype(np.float32)
        return dict(images=images, P2=P2)
