"""Synthetic fixtures for smoke runs and tests (counterpart of
``visualdet3d_tpu/testing.py``): the YOLOStereo3D benchmark config,
synthetic anchor priors, and seeded values for the zero-initialised
prediction convs of a random-weight model."""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from visualdet3d_tpu_torch.config import EasyDict as edict


def write_synthetic_priors(preprocessed_path: str, obj_types, num_scales: int = 16,
                           num_ratios: int = 2, pyramid_levels: int = 1) -> str:
    """anchor_mean/std_{type}.npy with plausible KITTI Car statistics."""
    d = os.path.join(preprocessed_path, 'training')
    os.makedirs(d, exist_ok=True)
    shape = (num_scales * pyramid_levels, num_ratios, 6)
    for t in obj_types:
        mean = np.zeros(shape, np.float32)
        # z decreasing with anchor size (large anchors = near objects)
        z = np.linspace(60.0, 5.0, shape[0], dtype=np.float32)
        mean[..., 0] = z[:, None]
        mean[..., 1] = 0.0
        mean[..., 2] = 0.3
        mean[..., 3:] = np.array([1.6, 1.5, 3.9], np.float32)
        std = np.full(shape, 1.0, np.float32)
        std[..., 0] = 8.0
        std[..., 1:3] = 0.6
        std[..., 3:] = 0.25
        _atomic_save(os.path.join(d, f'anchor_mean_{t}.npy'), mean)
        _atomic_save(os.path.join(d, f'anchor_std_{t}.npy'), std)
    return preprocessed_path


def _atomic_save(path: str, arr: np.ndarray) -> None:
    """np.save via rename: concurrent processes never observe a half-written
    file."""
    tmp = f'{path}.tmp.{os.getpid()}.npy'  # .npy suffix: np.save appends it otherwise
    try:
        np.save(tmp, arr)
        os.replace(tmp, path)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)


def stereo3d_detector_cfg(preprocessed_path: str, obj_types=('Car', 'Pedestrian'),
                          depth: int = 34) -> edict:
    """The YOLOStereo3D benchmark config (mirrors config/Stereo3D_example)."""
    obj_types = list(obj_types)
    anchors = edict(
        pyramid_levels=[4], strides=[16], sizes=[24],
        ratios=np.array([0.5, 1.0, 2.0]),
        scales=np.array([2 ** (i / 4.0) for i in range(16)]),
    )
    detector = edict(
        obj_types=obj_types,
        name='Stereo3D',
        backbone=edict(depth=depth, pretrained=False, frozen_stages=-1,
                       num_stages=3, out_indices=(0, 1, 2), norm_eval=True,
                       dilations=(1, 1, 1), s2d_stem=True),
        head=edict(
            num_regression_loss_terms=13,
            preprocessed_path=preprocessed_path,
            num_classes=len(obj_types),
            anchors_cfg=anchors,
            layer_cfg=edict(
                num_features_in=1408,
                num_cls_output=len(obj_types) + 1,
                num_reg_output=12,
                cls_feature_size=256,
                reg_feature_size=1408,
            ),
            loss_cfg=edict(
                fg_iou_threshold=0.5, bg_iou_threshold=0.4,
                L1_regression_alpha=25, focal_loss_gamma=2.0,
                balance_weight=[20.0, 40.0][:len(obj_types)],
                regression_weight=[1, 1, 1, 1, 1, 1, 12, 1, 1, 0.5, 0.5, 0.5, 1],
            ),
            test_cfg=edict(score_thr=0.75, cls_agnostic=False,
                           nms_iou_thr=0.4, post_optimization=False),
        ),
    )
    detector.anchors = detector.head.anchors_cfg
    detector.loss = detector.head.loss_cfg
    return detector


# logit statistics of calibrate_prediction_convs: mean -3 and std 1.5 put a
# few hundred of the 69,120 anchors of a 288x1280 image above score 0.75
CLS_LOGIT_MEAN, CLS_LOGIT_STD, REG_STD = -3.0, 1.5, 0.5


@torch.no_grad()
def calibrate_prediction_convs(system, left_images, right_images,
                               generator: torch.Generator) -> None:
    """Give a random-weight model's zero-initialised prediction convs seeded
    values, scaled so that on these images the class logits have mean
    ``CLS_LOGIT_MEAN`` and std ``CLS_LOGIT_STD`` and the regressions std
    ``REG_STD``.

    With zero prediction convs every score is sigmoid(0) = 0.5, under any
    useful ``score_thr``, so decode and NMS would see no candidate. The
    logits are affine in the conv's weight and bias, so one forward pass
    with unit-normal weights fixes the scale exactly.
    """
    cls_conv, reg_conv = system.prediction_convs()
    for conv in (cls_conv, reg_conv):
        w = torch.randn(conv.weight.shape, generator=generator)
        conv.weight.copy_(w.to(conv.weight.device))
        conv.bias.zero_()
    system.weights_changed()
    cls_preds, reg_preds = system.predict_raw(left_images, right_images)
    for conv, preds, mean, std in ((cls_conv, cls_preds, CLS_LOGIT_MEAN, CLS_LOGIT_STD),
                                   (reg_conv, reg_preds, 0.0, REG_STD)):
        preds = preds.float()
        a = std / float(preds.std())
        b = mean - a * float(preds.mean())
        conv.weight.mul_(a)
        conv.bias.fill_(b)
    system.weights_changed()
