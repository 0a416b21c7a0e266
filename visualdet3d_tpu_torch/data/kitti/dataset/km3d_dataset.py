"""The KM3D/RTM3D and MonoFlex target builders, numpy on the host
(counterparts of ``KittiRTM3DDataset._build_target``, ``collate_fn`` and
``KittiMonoFlexDataset`` in
``visualdet3d_tpu/data/kitti/dataset/km3d_dataset.py``): the center and
vertex heatmaps with gaussian radii, index tensors, multibin rotation
targets and the 9-point (8 corners + 3-D center) projection; for MonoFlex
the 10 keypoints (8 corners + the bottom and top face centers) with the
projected 3-D center as the heatmap peak, FCOS 2-D box targets,
keypoint-depth validity masks and the boundary indices of edge fusion.

The builders need no image file: they take the image's height and width.
``KittiRTM3DDataset`` and ``KittiMonoFlexDataset`` are the KITTI datasets
on top of them (the mono dataset's imdb, image and augmentations, no
right-image doubling). Heatmaps are built [H, W, C] (NHWC), the head's
layout.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import numpy as np

from visualdet3d_tpu_torch import geometry
from visualdet3d_tpu_torch.data.kitti.dataset.mono_dataset import KittiMonoDataset
from visualdet3d_tpu_torch.data.kitti.kittidata import KittiObj
from visualdet3d_tpu_torch.models.heads.rtm3d_utils import gaussian_radius, gen_hm_radius
from visualdet3d_tpu_torch.registry import DATASET_DICT

# 9-point corner matrix: 8 corners + the 3-D center
RTM3D_CORNERS = np.concatenate(
    [geometry.CORNER_MATRIX, np.zeros((1, 3), np.float32)], axis=0)
# 11-point: 8 corners + the bottom and top face centers + the 3-D center
MONOFLEX_CORNERS = np.concatenate([
    geometry.CORNER_MATRIX,
    np.array([[0, 1, 0], [0, -1, 0], [0, 0, 0]], np.float32)], axis=0)


def _project_corners(P2: np.ndarray, labels: List[KittiObj], corner_matrix):
    """[N, K, 3] camera corners and [N, K, 3] image projections of the
    corner set ``corner_matrix`` of each object."""
    box7 = np.array([[o.x, o.y - 0.5 * o.h, o.z, o.w, o.h, o.l, o.alpha]
                     for o in labels], np.float32).reshape(-1, 7)
    rel = 0.5 * corner_matrix[None] * box7[:, None, 3:6]
    thetas = geometry.alpha2theta_3d(box7[:, 6], box7[:, 0], box7[:, 2], P2)
    cos, sin = np.cos(thetas)[:, None], np.sin(thetas)[:, None]
    rx = rel[:, :, 2] * cos + rel[:, :, 0] * sin
    rz = -rel[:, :, 2] * sin + rel[:, :, 0] * cos
    abs_c = np.stack([rx, rel[:, :, 1], rz], -1) + box7[:, None, :3]
    ones = np.ones(abs_c.shape[:-1] + (1,), np.float32)
    cam = np.einsum('ij,nkj->nki', P2, np.concatenate([abs_c, ones], -1))
    homo = cam / (cam[:, :, 2:] + 1e-6)
    return abs_c, homo


class RTM3DTargetBuilder:
    """Targets of one image for the KM3D loss."""

    num_vertexes = 9
    corner_matrix = RTM3D_CORNERS

    def __init__(self, obj_types: Sequence[str], max_objects: int = 32):
        self.obj_types = list(obj_types)
        self.num_classes = len(self.obj_types)
        self.max_objects = max_objects

    def build_target(self, image_hw: Tuple[int, int], P2: np.ndarray, labels: List[KittiObj],
                     scale: int = 4) -> Dict[str, np.ndarray]:
        """Targets for ``labels`` (objects of ``obj_types``) in an image of
        ``image_hw``; sets each object's ``alpha`` from its yaw, as the JAX
        builder does."""
        num_objects = len(labels)
        nv = self.num_vertexes
        hm_h, hm_w = image_hw[0] // scale, image_hw[1] // scale
        mo = self.max_objects

        hm_main = np.zeros((hm_h, hm_w, self.num_classes), np.float32)
        hm_ver = np.zeros((hm_h, hm_w, nv), np.float32)
        cen_offset = np.zeros((mo, 2), np.float32)
        indices_center = np.zeros((mo,), np.int64)
        obj_mask = np.zeros((mo,), np.uint8)
        location = np.zeros((mo, 3), np.float32)
        orientation = np.zeros((mo, 1), np.float32)
        rotbin = np.zeros((mo, 2), np.int64)
        rotres = np.zeros((mo, 2), np.float32)
        ver_coor = np.zeros((mo, nv * 2), np.float32)
        ver_coor_mask = np.zeros((mo, nv * 2), np.uint8)
        ver_offset = np.zeros((mo * nv, 2), np.float32)
        ver_offset_mask = np.zeros((mo * nv,), np.uint8)
        indices_vertexes = np.zeros((mo * nv,), np.int64)
        dimension = np.zeros((mo, 3), np.float32)
        rots = np.zeros((mo, 2), np.float32)
        depth = np.zeros((mo, 1), np.float32)
        whs = np.zeros((mo, 2), np.float32)

        for obj in labels:
            obj.alpha = float(geometry.theta2alpha_3d(obj.ry, obj.x, obj.z, P2))
        if num_objects > 0:
            _, homo_corner = _project_corners(P2, labels, self.corner_matrix)

        for k in range(min(num_objects, mo)):
            obj = labels[k]
            cls_id = self.obj_types.index(obj.type)
            bbox = np.array([obj.bbox_l, obj.bbox_t, obj.bbox_r, obj.bbox_b])
            orientation[k] = obj.ry
            dim = np.array([obj.w, obj.h, obj.l])
            alpha = obj.alpha

            # multibin targets
            if np.sin(alpha) < 0.5:
                rotbin[k, 0] = 1
                rotres[k, 0] = alpha + 0.5 * np.pi
            if np.sin(alpha) > -0.5:
                rotbin[k, 1] = 1
                rotres[k, 1] = alpha - 0.5 * np.pi

            bbox = bbox / scale
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, hm_w)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, hm_h)
            bbox_h, bbox_w = bbox[3] - bbox[1], bbox[2] - bbox[0]
            if bbox_h <= 0 or bbox_w <= 0:
                continue
            location[k] = [obj.x, obj.y - 0.5 * obj.h, obj.z]
            radius = max(0, int(gaussian_radius((np.ceil(bbox_h), np.ceil(bbox_w)))))

            vertexes_2d = homo_corner[k, :nv, 0:2] / scale
            center = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2], np.float32)
            center_int = center.astype(np.int32)
            if not (0 <= center_int[0] < hm_w and 0 <= center_int[1] < hm_h):
                continue
            gen_hm_radius(hm_main[:, :, cls_id], center, radius)
            indices_center[k] = center_int[1] * hm_w + center_int[0]

            for vi, ver in enumerate(vertexes_2d):
                ver_int = ver.astype(np.int32)
                ver_coor[k, vi * 2:(vi + 1) * 2] = ver - center_int
                ver_coor_mask[k, vi * 2:(vi + 1) * 2] = 1
                if (0 <= ver_int[0] < hm_w) and (0 <= ver_int[1] < hm_h):
                    gen_hm_radius(hm_ver[:, :, vi], ver_int, radius)
                    ver_offset[k * nv + vi] = ver - ver_int
                    ver_offset_mask[k * nv + vi] = 1
                    indices_vertexes[k * nv + vi] = ver_int[1] * hm_w + ver_int[0]

            cen_offset[k] = center - center_int
            dimension[k] = dim
            rots[k] = [np.sin(alpha), np.cos(alpha)]
            depth[k] = obj.z
            whs[k] = [bbox_w, bbox_h]
            obj_mask[k] = 1

        return {
            'hm': hm_main, 'hm_hp': hm_ver, 'hps': ver_coor, 'reg': cen_offset,
            'hp_offset': ver_offset, 'dim': dimension, 'rots': rots,
            'rotbin': rotbin, 'rotres': rotres, 'dep': depth,
            'ind': indices_center, 'hp_ind': indices_vertexes,
            'reg_mask': obj_mask, 'hps_mask': ver_coor_mask,
            'hp_mask': ver_offset_mask, 'wh': whs, 'location': location,
            'ori': orientation,
        }

    @staticmethod
    def collate_fn(batch) -> Dict:
        """Items ``{'image', 'calib', 'label'}`` -> ``{'images' [B, H, W, 3]
        f32, 'P2' [B, 3, 4] f32, 'gts': {key: [B, ...]}}``."""
        images = np.stack([item['image'] for item in batch]).astype(np.float32)
        P2 = np.stack([item['calib'] for item in batch]).astype(np.float32)
        gts = {key: np.stack([item['label'][key] for item in batch])
               for key in batch[0]['label']}
        return dict(images=images, P2=P2, gts=gts)


class MonoFlexTargetBuilder(RTM3DTargetBuilder):
    """Targets of one image for the MonoFlex loss."""

    num_vertexes = 10
    corner_matrix = MONOFLEX_CORNERS

    @staticmethod
    def _get_edge_utils(image_size: Tuple[int, int], down_ratio: int = 4) -> np.ndarray:
        """Boundary pixel indices of the stride-4 map for edge fusion, as
        the JAX package computes them (it passes (H, W) where the names say
        (W, H); kept, so that the targets match)."""
        x_min, y_min = 0, 0
        x_max, y_max = image_size[0] // down_ratio, image_size[1] // down_ratio
        edges = []
        y = np.arange(y_min, y_max)
        edges.append(np.stack((np.full(len(y), x_min), y), axis=1))
        x = np.arange(x_min, x_max)
        edges.append(np.stack((x, np.full(len(x), y_max)), axis=1))
        y = np.arange(y_max, y_min, -1)
        edges.append(np.stack((np.full(len(y), x_max), y), axis=1))
        x = np.arange(x_max, x_min - 1, -1)
        edges.append(np.stack((x, np.full(len(x), y_min)), axis=1))
        edge_indices = np.concatenate([e.astype(np.int64) for e in edges], axis=0)
        return np.unique(edge_indices, axis=0)

    def build_target(self, image_hw: Tuple[int, int], P2: np.ndarray, labels: List[KittiObj],
                     scale: int = 4) -> Dict[str, np.ndarray]:
        """MonoFlex targets for ``labels`` in an image of ``image_hw``; sets
        each object's ``alpha`` from its yaw, as the JAX builder does."""
        num_objects = len(labels)
        nv = self.num_vertexes
        hm_h, hm_w = image_hw[0] // scale, image_hw[1] // scale
        mo = self.max_objects

        hm_main = np.zeros((hm_h, hm_w, self.num_classes), np.float32)
        hm_ver = np.zeros((hm_h, hm_w, nv), np.float32)
        cen_offset = np.zeros((mo, 2), np.float32)
        indices_center = np.zeros((mo,), np.int64)
        obj_mask = np.zeros((mo,), np.uint8)
        bboxes2d = np.zeros((mo, 4), np.float32)
        fcos_bbox2d = np.zeros((mo, 4), np.float32)
        location = np.zeros((mo, 3), np.float32)
        orientation = np.zeros((mo, 1), np.float32)
        rotbin = np.zeros((mo, 2), np.int64)
        rotres = np.zeros((mo, 2), np.float32)
        ver_coor = np.zeros((mo, nv * 2), np.float32)
        ver_coor_mask = np.zeros((mo, nv * 2), np.uint8)
        ver_offset = np.zeros((mo * nv, 2), np.float32)
        ver_offset_mask = np.zeros((mo * nv,), np.uint8)
        indices_vertexes = np.zeros((mo * nv,), np.int64)
        kp_depth_mask = np.zeros((mo, 3), np.float32)
        dimension = np.zeros((mo, 3), np.float32)
        rots = np.zeros((mo, 2), np.float32)
        depth = np.zeros((mo, 1), np.float32)
        whs = np.zeros((mo, 2), np.float32)

        for obj in labels:
            obj.alpha = float(geometry.theta2alpha_3d(obj.ry, obj.x, obj.z, P2))
        if num_objects > 0:
            abs_corner, homo_corner = _project_corners(P2, labels, self.corner_matrix)

        edge_indices = self._get_edge_utils((image_hw[0], image_hw[1]))

        for k in range(min(num_objects, mo)):
            obj = labels[k]
            cls_id = self.obj_types.index(obj.type)
            bbox = np.array([obj.bbox_l, obj.bbox_t, obj.bbox_r, obj.bbox_b])
            orientation[k] = obj.ry
            dim = np.array([obj.w, obj.h, obj.l])
            alpha = obj.alpha
            if np.sin(alpha) < 0.5:
                rotbin[k, 0] = 1
                rotres[k, 0] = alpha + 0.5 * np.pi
            if np.sin(alpha) > -0.5:
                rotbin[k, 1] = 1
                rotres[k, 1] = alpha - 0.5 * np.pi

            bbox = bbox / scale
            bboxes2d[k] = bbox
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, hm_w)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, hm_h)
            bbox_h, bbox_w = bbox[3] - bbox[1], bbox[2] - bbox[0]
            if bbox_h <= 0 or bbox_w <= 0:
                continue
            location[k] = [obj.x, obj.y - 0.5 * obj.h, obj.z]
            radius = max(0, int(gaussian_radius((np.ceil(bbox_h), np.ceil(bbox_w)))))

            vertexes_2d = homo_corner[k, :nv, 0:2] / scale
            vis_x = (vertexes_2d[:, 0] >= 0) & (vertexes_2d[:, 0] <= hm_w)
            vis_y = (vertexes_2d[:, 1] >= 0) & (vertexes_2d[:, 1] <= hm_h)
            vis_z = abs_corner[k, :nv, 2] > 0
            visible = vis_x & vis_y & vis_z
            # MonoFlex's modified keypoint visibility: a corner counts if it
            # or the one above/below it is visible
            visible = np.append(
                np.tile(visible[:4] | visible[4:8], 2),
                np.tile(visible[8] | visible[9], 2))
            kp_depth_valid = np.stack((
                visible[[8, 9]].all(),
                visible[[0, 2, 4, 6]].all(),
                visible[[1, 3, 5, 7]].all())).astype(np.float32)

            # the projected 3-D center is the heatmap peak
            center = homo_corner[k, nv, 0:2] / scale
            center_int = center.astype(np.int32)
            if not (0 <= center_int[0] < hm_w and 0 <= center_int[1] < hm_h):
                continue
            gen_hm_radius(hm_main[:, :, cls_id], center, radius)
            indices_center[k] = center_int[1] * hm_w + center_int[0]

            for vi, ver in enumerate(vertexes_2d):
                ver_int = ver.astype(np.int32)
                ver_coor[k, vi * 2:(vi + 1) * 2] = ver - center_int
                ver_coor_mask[k, vi * 2:(vi + 1) * 2] = 1
                if (0 <= ver_int[0] < hm_w) and (0 <= ver_int[1] < hm_h):
                    gen_hm_radius(hm_ver[:, :, vi], ver_int, radius)
                    ver_offset[k * nv + vi] = ver - ver_int
                    ver_offset_mask[k * nv + vi] = 1
                    indices_vertexes[k * nv + vi] = ver_int[1] * hm_w + ver_int[0]

            cen_offset[k] = center - center_int
            fcos_bbox2d[k] = [center_int[0] - bbox[0], center_int[1] - bbox[1],
                              bbox[2] - center_int[0], bbox[3] - center_int[1]]
            dimension[k] = dim
            rots[k] = [np.sin(alpha), np.cos(alpha)]
            depth[k] = obj.z
            whs[k] = [bbox_w, bbox_h]
            obj_mask[k] = 1
            kp_depth_mask[k] = kp_depth_valid

        return {
            'hm': hm_main, 'hm_hp': hm_ver, 'hps': ver_coor, 'reg': cen_offset,
            'hp_offset': ver_offset, 'dim': dimension, 'rots': rots,
            'rotbin': rotbin, 'rotres': rotres, 'dep': depth,
            'ind': indices_center, 'hp_ind': indices_vertexes,
            'reg_mask': obj_mask, 'hps_mask': ver_coor_mask,
            'hp_mask': ver_offset_mask, 'kp_detph_mask': kp_depth_mask,
            'wh': whs, 'bboxes2d': bboxes2d, 'bboxes2d_target': fcos_bbox2d,
            'location': location, 'ori': orientation,
            'edge_indices': edge_indices,
        }


@DATASET_DICT.register_module
class KittiRTM3DDataset(KittiMonoDataset):
    """KITTI images with KM3D targets (``RTM3DTargetBuilder``), 32 objects
    an image."""

    target_builder = RTM3DTargetBuilder

    def __init__(self, cfg, split='training'):
        super().__init__(cfg, split)
        self.builder = self.target_builder(self.obj_types, max_objects=32)

    def __getitem__(self, index):
        record, image, P2 = self._load_record(index)
        label = [copy.deepcopy(o) for o in record['label'] if o.type in self.obj_types]
        transformed_image, transformed_P2, transformed_label = self.transform(
            image, p2=P2.copy(), labels=label)
        targets = self.builder.build_target(transformed_image.shape[:2], transformed_P2,
                                            transformed_label)
        return {'calib': transformed_P2, 'image': transformed_image,
                'label': targets, 'original_shape': image.shape,
                'original_P': record['calib']['P2'].copy()}

    def __len__(self):
        return len(self.imdb)

    @staticmethod
    def collate_fn(batch, obj_types=None, max_objects: int = 32):
        return RTM3DTargetBuilder.collate_fn(batch)


@DATASET_DICT.register_module
class KittiMonoFlexDataset(KittiRTM3DDataset):
    """KITTI images with MonoFlex targets (``MonoFlexTargetBuilder``)."""

    target_builder = MonoFlexTargetBuilder
