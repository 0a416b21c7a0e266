"""Synthetic fixtures for smoke runs and tests (counterpart of
``visualdet3d_tpu/testing.py``): the YOLOStereo3D and KM3D configs,
synthetic anchor priors, and seeded values for the zero-initialised
prediction, offset and heatmap convs of a random-weight model."""
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


def km3d_detector_cfg(obj_types=('Car',), head_features: int = 256, top_k: int = 100) -> edict:
    """The KM3D config (mirrors configs/km3d.py: DLA-34, the RTM3D head dict,
    ``head_features=256``, score_thr 0.1, NMS IoU 0.5, top-K 100)."""
    obj_types = list(obj_types)
    return edict(
        obj_types=obj_types,
        name='KM3D',
        backbone=edict(name='dla', depth=34),
        head=edict(
            num_classes=len(obj_types),
            num_joints=9,
            max_objects=32,
            layer_cfg=edict(
                input_features=64,
                head_features=head_features,
                head_dict={'hm': len(obj_types), 'wh': 2, 'hps': 18, 'rot': 8, 'dim': 3,
                           'prob': 1, 'reg': 2, 'hm_hp': 9, 'hp_offset': 2},
            ),
            loss_cfg=edict(gamma=2.0, rampup_length=100),
            test_cfg=edict(score_thr=0.1, cls_agnostic=True, nms_iou_thr=0.5, top_k=top_k,
                           post_optimization=False),
        ),
    )


@torch.no_grad()
def seed_offset_convs(system, generator: torch.Generator, scale: float, images) -> None:
    """Give the zero-initialised offset convs of every ``ModulatedDeformConv``
    seeded normal weights (zero bias), scaled so that on these images each
    DCN's offsets have std ``scale`` pixels: fractions of a pixel to beyond
    the image edge. The mask logits take the same factor. With zero offsets
    every DCN is a plain conv with mask 0.5 and the interpolation goes
    untested.

    One f32 forward pass: a hook on each offset conv rescales its weight
    and its output (linear in the weight, with zero bias) before the next
    layer reads it, so every DCN sees the offsets the seeded model will
    produce.
    """
    from visualdet3d_tpu_torch.models.blocks import ModulatedDeformConv

    def rescale(conv, _, out):
        k2 = 2 * out.shape[1] // 3
        a = scale / float(out[:, :k2].std())
        conv.weight.mul_(a)
        return out * a

    hooks = []
    for m in system.net.modules():
        if isinstance(m, ModulatedDeformConv):
            conv = m.Conv_0
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                              .to(conv.weight.device))
            conv.bias.zero_()
            hooks.append(conv.register_forward_hook(rescale))
    try:
        system.net(system._images(images, torch.float32))
    finally:
        for h in hooks:
            h.remove()
    system.weights_changed()


# statistics of the head's output maps after calibrate_head_convs, (mean, std)
# over a batch, in map units: heatmap logits around the 0.1 score threshold
# (sigmoid(-2.197), 1.9 std above the mean, so ~3% of the map and a share of
# its peaks score above it, spread, not on it); box sizes of a few
# stride-4 cells, dimensions around a car's metres, keypoints a few cells
# from their center
HEAD_OUTPUT_STATS = {'hm': (-5.0, 1.5), 'hm_hp': (-5.0, 1.5), 'wh': (6.0, 2.0),
                     'hps': (0.0, 4.0), 'rot': (0.0, 1.0), 'dim': (2.0, 1.0),
                     'prob': (0.0, 1.0), 'reg': (0.5, 0.2), 'hp_offset': (0.5, 0.2)}


@torch.no_grad()
def calibrate_head_convs(system, images, generator: torch.Generator) -> None:
    """Give every ``{name}_out`` conv of the KM3D head seeded weights scaled
    so that on these images its outputs have the mean and std of
    ``HEAD_OUTPUT_STATS``.

    The initial heatmap bias of -2.19 puts every score of a random-weight
    model at 0.1, exactly the threshold, so the valid set would be decided
    by rounding; the other branches' normal(0.001) weights give boxes of
    zero size and 3D positions at the camera, where the position solve
    divides by ~0. The outputs are affine in the conv's weight and bias, so
    one forward pass with unit-normal weights fixes them exactly.
    """
    head = system.net.KM3DHeadNet_0
    convs = {name: getattr(head, f'{name}_out') for name, _ in head.head_dict}
    for conv in convs.values():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                          .to(conv.weight.device))
        conv.bias.zero_()
    system.weights_changed()
    raw = system.predict_raw(images)
    for name, conv in convs.items():
        mean, std = HEAD_OUTPUT_STATS[name]
        preds = raw[name].float()
        a = std / float(preds.std())
        conv.weight.mul_(a)
        conv.bias.fill_(mean - a * float(preds.mean()))
    system.weights_changed()
