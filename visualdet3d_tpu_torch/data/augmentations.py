"""Calibration-aware data augmentation on the host (counterpart of
``visualdet3d_tpu/data/augmentations.py``): ``Compose``,
``build_augmentator`` and the 18 registered transforms, with the same
names and keyword signatures as the config files use.

Every geometric transform also edits the calibration matrices P2/P3 and
the 2-D boxes, so that the 3-D to 2-D projection stays exact after it
(``CropTop``'s cy/ty shift, ``RandomMirror``'s P2/P3 swap and yaw flip).
Transforms pass a sample dict along. Every random draw goes through
numpy's global generator (``numpy.random``) in the JAX package's order and
with its calls, so under one ``np.random.seed`` both packages draw the same
numbers. The image operations are ``data/cv_ops.py``'s (no OpenCV).
"""
from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
from numpy import random

from visualdet3d_tpu_torch.data import cv_ops
from visualdet3d_tpu_torch.geometry import theta2alpha_3d
from visualdet3d_tpu_torch.registry import AUGMENTATION_DICT

SAMPLE_KEYS = ('left_image', 'right_image', 'p2', 'p3', 'labels', 'image_gt', 'lidar')


def _sample(left_image, right_image=None, p2=None, p3=None, labels=None,
            image_gt=None, lidar=None) -> dict:
    return dict(left_image=left_image, right_image=right_image, p2=p2, p3=p3,
                labels=labels, image_gt=image_gt, lidar=lidar)


def build_single_augmentator(cfg):
    name = cfg['type_name']
    keywords = dict(cfg.get('keywords', {}))
    return AUGMENTATION_DICT[name](**keywords)


@AUGMENTATION_DICT.register_module
class Compose:
    """Chain augmentators built from their config entries."""

    def __init__(self, aug_list=(), is_return_all: bool = True):
        self.transforms: List[Callable] = [build_single_augmentator(c) for c in aug_list]
        self.is_return_all = is_return_all

    def __call__(self, left_image, right_image=None, p2=None, p3=None,
                 labels=None, image_gt=None, lidar=None):
        s = _sample(left_image, right_image, p2, p3, labels, image_gt, lidar)
        for t in self.transforms:
            s = t(s)
        items = [s[k] for k in SAMPLE_KEYS]
        if self.is_return_all:
            return items
        return [item for item in items if item is not None]


def build_augmentator(aug_cfg) -> Compose:
    return Compose(aug_cfg, is_return_all=False)


def _apply_images(s: dict, fn) -> dict:
    s['left_image'] = fn(s['left_image'])
    if s['right_image'] is not None:
        s['right_image'] = fn(s['right_image'])
    return s


@AUGMENTATION_DICT.register_module
class ConvertToFloat:
    """uint8 -> float32."""

    def __call__(self, s: dict) -> dict:
        return _apply_images(s, lambda im: im.astype(np.float32))


@AUGMENTATION_DICT.register_module
class Normalize:
    """x/255 -> -mean -> /std; mean/std tiled over channel groups of 3."""

    def __init__(self, mean, stds):
        self.mean = np.asarray(mean, np.float32)
        self.stds = np.asarray(stds, np.float32)

    def __call__(self, s: dict) -> dict:
        def norm(im):
            im = im.astype(np.float32) / 255.0
            reps = im.shape[2] // self.mean.shape[0]
            im = im - np.tile(self.mean, reps)
            im = im / np.tile(self.stds, reps)
            return im.astype(np.float32)
        return _apply_images(s, norm)


@AUGMENTATION_DICT.register_module
class Resize:
    """Resize to target height (optionally preserving aspect), crop/pad width;
    scales P2/P3 rows 0-1 and 2D boxes."""

    def __init__(self, size, preserve_aspect_ratio=True):
        self.size = size
        self.preserve_aspect_ratio = preserve_aspect_ratio

    def __call__(self, s: dict) -> dict:
        im = s['left_image']
        if self.preserve_aspect_ratio:
            scale = self.size[0] / im.shape[0]
            h = int(np.round(im.shape[0] * scale))
            w = int(np.round(im.shape[1] * scale))
            sy, sx = scale, scale
        else:
            h, w = self.size[0], self.size[1]
            sy, sx = self.size[0] / im.shape[0], self.size[1] / im.shape[1]

        def resize(img, interp=cv_ops.INTER_LINEAR):
            return cv_ops.resize(img, (w, h), interp)

        s = _apply_images(s, resize)
        if s['image_gt'] is not None:
            s['image_gt'] = cv_ops.resize(s['image_gt'], (w, h), cv_ops.INTER_NEAREST)

        if len(self.size) > 1:
            target_w = self.size[1]

            def fix_width(img):
                if img.shape[1] > target_w:
                    return img[:, :target_w]
                if img.shape[1] < target_w:
                    pad = target_w - img.shape[1]
                    pads = [(0, 0), (0, pad)] + [(0, 0)] * (img.ndim - 2)
                    return np.pad(img, pads, 'constant')
                return img
            s = _apply_images(s, fix_width)
            if s['image_gt'] is not None:
                s['image_gt'] = fix_width(s['image_gt'])

        for key in ('p2', 'p3'):
            if s[key] is not None:
                s[key][0, :] *= sx
                s[key][1, :] *= sy
        if s['labels']:
            for obj in s['labels']:
                obj.bbox_l *= sx
                obj.bbox_r *= sx
                obj.bbox_t *= sy
                obj.bbox_b *= sy
        return s


@AUGMENTATION_DICT.register_module
class ResizeToFx:
    """Resize so fx/fy match preset values."""

    def __init__(self, Fx=721.5337, Fy=None):
        self.Fx = Fx
        self.Fy = Fy if Fy is not None else Fx

    def __call__(self, s: dict) -> dict:
        if s['p2'] is None:
            return s
        h0, w0 = s['left_image'].shape[:2]
        fx0, fy0 = s['p2'][0, 0], s['p2'][1, 1]
        h1 = int(h0 * self.Fy / fy0)
        w1 = int(w0 * self.Fx / fx0)
        sy, sx = h1 / h0, w1 / w0
        s = _apply_images(s, lambda im: cv_ops.resize(im, (w1, h1)))
        if s['image_gt'] is not None:
            s['image_gt'] = cv_ops.resize(s['image_gt'], (w1, h1), cv_ops.INTER_NEAREST)
        for key in ('p2', 'p3'):
            if s[key] is not None:
                s[key][0, :] *= sx
                s[key][1, :] *= sy
        if s['labels']:
            for obj in s['labels']:
                obj.bbox_l *= sx
                obj.bbox_r *= sx
                obj.bbox_t *= sy
                obj.bbox_b *= sy
        return s


@AUGMENTATION_DICT.register_module
class CropTop:
    """Crop rows from the top; cy' = cy - dv, ty' = ty - dv*tz."""

    def __init__(self, crop_top_index=None, output_height=None):
        if crop_top_index is None and output_height is None:
            crop_top_index = 0
        self.crop_top_index = crop_top_index
        self.output_height = output_height

    def __call__(self, s: dict) -> dict:
        height = s['left_image'].shape[0]
        if self.crop_top_index is not None:
            upper = self.crop_top_index
        else:
            upper = height - self.output_height
        s = _apply_images(s, lambda im: im[upper:height])
        if s['image_gt'] is not None:
            s['image_gt'] = s['image_gt'][upper:height]
        for key in ('p2', 'p3'):
            if s[key] is not None:
                s[key][1, 2] -= upper
                s[key][1, 3] -= upper * s[key][2, 3]
        if s['labels']:
            for obj in s['labels']:
                obj.bbox_t -= upper
                obj.bbox_b -= upper
        return s


@AUGMENTATION_DICT.register_module
class CropRight:
    """Crop columns from the right; no calibration change needed."""

    def __init__(self, crop_right_index=None, output_width=None):
        if crop_right_index is None and output_width is None:
            crop_right_index = 0
        self.crop_right_index = crop_right_index
        self.output_width = output_width

    def __call__(self, s: dict) -> dict:
        width = s['left_image'].shape[1]
        if self.crop_right_index is not None:
            righter = width - self.crop_right_index
        else:
            righter = self.output_width
        if righter > width:
            return s
        s = _apply_images(s, lambda im: im[:, :righter])
        if s['image_gt'] is not None:
            s['image_gt'] = s['image_gt'][:, :righter]
        return s


@AUGMENTATION_DICT.register_module
class FilterObject:
    """Drop objects entirely outside the image."""

    def __call__(self, s: dict) -> dict:
        if s['labels'] is None:
            return s
        h, w = s['left_image'].shape[:2]
        s['labels'] = [obj for obj in s['labels'] if not (
            obj.bbox_b < 0 or obj.bbox_t > h or obj.bbox_r < 0 or obj.bbox_l > w)]
        return s


@AUGMENTATION_DICT.register_module
class RandomCropToWidth:
    """Random horizontal crop to a fixed width; cx' = cx - du,
    tx' = tx - du*tz."""

    def __init__(self, width: int):
        self.width = width

    def __call__(self, s: dict) -> dict:
        original_width = s['left_image'].shape[1]
        if self.width > original_width:
            return s
        lefter = np.random.randint(0, original_width - self.width)
        righter = lefter + self.width
        s = _apply_images(s, lambda im: im[:, lefter:righter])
        if s['image_gt'] is not None:
            s['image_gt'] = s['image_gt'][:, lefter:righter]
        for key in ('p2', 'p3'):
            if s[key] is not None:
                s[key][0, 2] -= lefter
                s[key][0, 3] -= lefter * s[key][2, 3]
        if s['labels']:
            for obj in s['labels']:
                obj.bbox_l -= lefter
                obj.bbox_r -= lefter
        return s


@AUGMENTATION_DICT.register_module
class RandomMirror:
    """Horizontal flip: swap eyes and P2/P3, negate tx, mirror cx, flip 3D
    x/yaw, recompute alpha."""

    def __init__(self, mirror_prob):
        self.mirror_prob = mirror_prob

    def __call__(self, s: dict) -> dict:
        if random.rand() > self.mirror_prob:
            return s
        width = s['left_image'].shape[1]
        s['left_image'] = np.ascontiguousarray(s['left_image'][:, ::-1])
        if s['right_image'] is not None:
            s['right_image'] = np.ascontiguousarray(s['right_image'][:, ::-1])
            s['left_image'], s['right_image'] = s['right_image'], s['left_image']
        if s['image_gt'] is not None:
            s['image_gt'] = np.ascontiguousarray(s['image_gt'][:, ::-1])
        if s['p2'] is not None and s['p3'] is not None:
            s['p2'], s['p3'] = s['p3'], s['p2']
        for key in ('p2', 'p3'):
            if s[key] is not None:
                s[key][0, 3] = -s[key][0, 3]
                s[key][0, 2] = width - s[key][0, 2] - 1
        if s['labels']:
            for obj in s['labels']:
                obj.bbox_l, obj.bbox_r = (width - obj.bbox_r - 1,
                                          width - obj.bbox_l - 1)
                obj.x = -obj.x
                ry = obj.ry
                ry = (-math.pi - ry) if ry < 0 else (math.pi - ry)
                while ry > math.pi:
                    ry -= 2 * math.pi
                while ry < -math.pi:
                    ry += 2 * math.pi
                obj.ry = ry
                obj.alpha = float(theta2alpha_3d(ry, obj.x, obj.z, s['p2']))
        if s['lidar'] is not None:
            s['lidar'][..., 0] = -s['lidar'][..., 0]
        return s


@AUGMENTATION_DICT.register_module
class RandomWarpAffine:
    """Random scale + center shift, resize to fixed output; full P edit."""

    def __init__(self, scale_lower=0.6, scale_upper=1.4, shift_border=128,
                 output_w=1280, output_h=384):
        self.scale_lower = scale_lower
        self.scale_upper = scale_upper
        self.shift_border = shift_border
        self.output_w = output_w
        self.output_h = output_h

    def __call__(self, s: dict) -> dict:
        im = s['left_image']
        s_original = max(im.shape[0], im.shape[1])
        scale = s_original * np.random.uniform(self.scale_lower, self.scale_upper)
        center_w = np.random.randint(self.shift_border, im.shape[1] - self.shift_border)
        center_h = np.random.randint(self.shift_border, im.shape[0] - self.shift_border)
        final_scale = max(self.output_w, self.output_h) / scale
        shift_w = self.output_w / 2 - center_w * final_scale
        shift_h = self.output_h / 2 - center_h * final_scale
        matrix = np.array([[final_scale, 0, shift_w],
                           [0, final_scale, shift_h]], np.float32)

        def warp(img):
            return cv_ops.warp_affine(img, matrix, (self.output_w, self.output_h))
        s = _apply_images(s, warp)
        if s['image_gt'] is not None:
            s['image_gt'] = warp(s['image_gt'])
        for key in ('p2', 'p3'):
            if s[key] is not None:
                s[key][0:2, :] *= final_scale
                s[key][0, 2] += shift_w
                s[key][0, 3] += shift_w * s[key][2, 3]
                s[key][1, 2] += shift_h
                s[key][1, 3] += shift_h * s[key][2, 3]
        if s['labels']:
            for obj in s['labels']:
                obj.bbox_l = obj.bbox_l * final_scale + shift_w
                obj.bbox_r = obj.bbox_r * final_scale + shift_w
                obj.bbox_t = obj.bbox_t * final_scale + shift_h
                obj.bbox_b = obj.bbox_b * final_scale + shift_h
        return s


@AUGMENTATION_DICT.register_module
class RandomSaturation:
    """HSV saturation scale. Assumes HSV input."""

    def __init__(self, distort_prob, lower=0.5, upper=1.5):
        assert upper >= lower >= 0
        self.distort_prob = distort_prob
        self.lower = lower
        self.upper = upper

    def __call__(self, s: dict) -> dict:
        if random.rand() <= self.distort_prob:
            ratio = random.uniform(self.lower, self.upper)
            s['left_image'][:, :, 1] *= ratio
            if s['right_image'] is not None:
                s['right_image'][:, :, 1] *= ratio
        return s


@AUGMENTATION_DICT.register_module
class RandomHue:
    """HSV hue shift with 360-degree wrap. Assumes HSV."""

    def __init__(self, distort_prob, delta=18.0):
        assert 0.0 <= delta <= 360.0
        self.distort_prob = distort_prob
        self.delta = delta

    def __call__(self, s: dict) -> dict:
        if random.rand() <= self.distort_prob:
            shift = random.uniform(-self.delta, self.delta)

            def hue(im):
                im[:, :, 0] += shift
                im[:, :, 0][im[:, :, 0] > 360.0] -= 360.0
                im[:, :, 0][im[:, :, 0] < 0.0] += 360.0
                return im
            s = _apply_images(s, hue)
        return s


@AUGMENTATION_DICT.register_module
class ConvertColor:
    """RGB <-> HSV."""

    def __init__(self, current='RGB', transform='HSV'):
        self.current = current
        self.transform = transform

    def __call__(self, s: dict) -> dict:
        if self.current == 'RGB' and self.transform == 'HSV':
            convert = cv_ops.rgb_to_hsv
        elif self.current == 'HSV' and self.transform == 'RGB':
            convert = cv_ops.hsv_to_rgb
        else:
            raise NotImplementedError((self.current, self.transform))
        return _apply_images(s, convert)


@AUGMENTATION_DICT.register_module
class RandomContrast:
    """Multiplicative contrast."""

    def __init__(self, distort_prob, lower=0.5, upper=1.5):
        assert upper >= lower >= 0
        self.distort_prob = distort_prob
        self.lower = lower
        self.upper = upper

    def __call__(self, s: dict) -> dict:
        if random.rand() <= self.distort_prob:
            alpha = random.uniform(self.lower, self.upper)
            s['left_image'] = s['left_image'] * alpha
            if s['right_image'] is not None:
                s['right_image'] = s['right_image'] * alpha
        return s


@AUGMENTATION_DICT.register_module
class RandomBrightness:
    """Additive brightness."""

    def __init__(self, distort_prob, delta=32):
        assert 0.0 <= delta <= 255.0
        self.distort_prob = distort_prob
        self.delta = delta

    def __call__(self, s: dict) -> dict:
        if random.rand() <= self.distort_prob:
            delta = random.uniform(-self.delta, self.delta)
            s['left_image'] = s['left_image'] + delta
            if s['right_image'] is not None:
                s['right_image'] = s['right_image'] + delta
        return s


@AUGMENTATION_DICT.register_module
class RandomEigenvalueNoise:
    """ImageNet PCA color noise."""

    def __init__(self, distort_prob=1.0, alphastd=0.1,
                 eigen_value=np.array([0.2141788, 0.01817699, 0.00341571], np.float32),
                 eigen_vector=np.array([
                     [-0.58752847, -0.69563484, 0.41340352],
                     [-0.5832747, 0.00994535, -0.81221408],
                     [-0.56089297, 0.71832671, 0.41158938],
                 ], np.float32)):
        self.distort_prob = distort_prob
        self._eig_val = eigen_value
        self._eig_vec = eigen_vector
        self.alphastd = alphastd

    def __call__(self, s: dict) -> dict:
        if random.rand() <= self.distort_prob:
            alpha = np.random.normal(scale=self.alphastd, size=(3,))
            noise = np.dot(self._eig_vec, self._eig_val * alpha) * 255
            s['left_image'] = s['left_image'] + noise
            if s['right_image'] is not None:
                s['right_image'] = s['right_image'] + noise
        return s


@AUGMENTATION_DICT.register_module
class PhotometricDistort:
    """Brightness + {contrast-first | contrast-last} HSV distortions."""

    def __init__(self, distort_prob=1.0, contrast_lower=0.5, contrast_upper=1.5,
                 saturation_lower=0.5, saturation_upper=1.5, hue_delta=18.0,
                 brightness_delta=32):
        self.transforms = [
            RandomContrast(distort_prob, contrast_lower, contrast_upper),
            ConvertColor(transform='HSV'),
            RandomSaturation(distort_prob, saturation_lower, saturation_upper),
            RandomHue(distort_prob, hue_delta),
            ConvertColor(current='HSV', transform='RGB'),
            RandomContrast(distort_prob, contrast_lower, contrast_upper),
        ]
        self.rand_brightness = RandomBrightness(distort_prob, brightness_delta)

    def __call__(self, s: dict) -> dict:
        if random.rand() <= 0.5:
            distortion = self.transforms[:-1]
        else:
            distortion = self.transforms[1:]
        s['left_image'] = s['left_image'].copy()
        if s['right_image'] is not None:
            s['right_image'] = s['right_image'].copy()
        for t in [self.rand_brightness] + distortion:
            s = t(s)
        return s


@AUGMENTATION_DICT.register_module
class Shuffle:
    """Apply a list of augmentators in random order."""

    def __init__(self, aug_list: List):
        self.transforms = [build_single_augmentator(c) for c in aug_list]

    def __call__(self, s: dict) -> dict:
        for index in np.random.permutation(len(self.transforms)):
            s = self.transforms[index](s)
        return s
