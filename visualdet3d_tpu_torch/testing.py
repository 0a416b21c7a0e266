"""Synthetic fixtures for smoke runs and tests (counterpart of
``visualdet3d_tpu/testing.py``): the YOLOStereo3D, KM3D and MonoFlex
configs, synthetic anchor priors, seeded values for the zero-initialised
prediction, offset and heatmap convs of a random-weight model, and
synthetic KM3D and MonoFlex training batches built by the ported target
builders."""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from visualdet3d_tpu_torch.config import EasyDict as edict

# the KITTI left camera's projection matrix (P2) for 384x1280 input
KITTI_P2 = np.array([
    [721.5377, 0.0, 609.5593, 44.85728],
    [0.0, 721.5377, 72.854, 0.2163791],
    [0.0, 0.0, 1.0, 0.002745884],
], np.float32)
KITTI_P2_HW = (384, 1280)


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


def int8_calibration_batches(image_hw, n_batches: int = 2, batch_size: int = 2, seed: int = 0):
    """Calibration batches of the int8 stereo path as the JAX package's
    ``bench.py`` draws them: ``n_batches`` tuples (left, right, P2) of
    standard-normal f32 image pairs [batch_size, H, W, 3] from
    ``np.random.default_rng(seed)`` (left, then right, per batch) and the
    KITTI P2 (numpy)."""
    rng = np.random.default_rng(seed)
    P2 = np.tile(KITTI_P2, (batch_size, 1, 1))
    return [(rng.standard_normal((batch_size, *image_hw, 3)).astype(np.float32),
             rng.standard_normal((batch_size, *image_hw, 3)).astype(np.float32), P2)
            for _ in range(n_batches)]


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


def monoflex_detector_cfg(obj_types=('Car',), head_features: int = 256,
                          top_k: int = 100) -> edict:
    """The MonoFlex config (mirrors configs/monoflex.py: DLA-34, the MonoFlex
    head dict, ``head_features=256``, 32 objects, the uncertainty range and
    weight of its loss, score_thr 0.1, NMS IoU 0.5, top-K 100)."""
    obj_types = list(obj_types)
    return edict(
        obj_types=obj_types,
        name='MonoFlex',
        backbone=edict(name='dla', depth=34),
        head=edict(
            num_classes=len(obj_types),
            num_joints=10,
            max_objects=32,
            layer_cfg=edict(
                input_features=64,
                head_features=head_features,
                head_dict={'hm': len(obj_types), 'bbox2d': 4, 'hps': 20, 'rot': 8, 'dim': 3,
                           'depth': 1, 'depth_uncertainty': 1, 'corner_uncertainty': 3,
                           'reg': 2},
            ),
            loss_cfg=edict(uncertainty_range=[-10, 10], uncertainty_weight=1.0),
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


@torch.no_grad()
def calibrate_batch_statistics(system, images) -> None:
    """Set every BatchNorm's running statistics to the batch statistics
    (mean, biased variance) of its input on these images, layer after
    layer, so that eval mode normalises them as train mode does. A
    random-weight model's running statistics (0 and 1) are far from its
    batch statistics; seeding and calibrating convs in eval mode would then
    tune them for a regime training never sees (a DCN whose offsets leave
    the image in train mode gives a constant channel, and train-mode BN
    divides its last-bit noise by sqrt(eps))."""
    from visualdet3d_tpu_torch.models.blocks import BatchNorm2d

    def set_stats(bn, inputs):
        x = inputs[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in system.net.modules()
             if isinstance(m, BatchNorm2d)]
    try:
        system.net(system._images(images, torch.float32))
    finally:
        for h in hooks:
            h.remove()
    system.weights_changed()


@torch.no_grad()
def prepare_km3d_for_training(system, images, generator: torch.Generator,
                              offset_std: float = 2.0, calibrate_head: bool = True) -> None:
    """A random-weight KM3D made ready to train on ``images``: running
    statistics set to the batch statistics, the offset convs seeded to
    offsets of std ``offset_std`` px, the statistics set again (the seeded
    offsets change the features) and, if ``calibrate_head``, the head's
    output convs calibrated (``calibrate_head_convs``)."""
    calibrate_batch_statistics(system, images)
    seed_offset_convs(system, generator, offset_std, images)
    calibrate_batch_statistics(system, images)
    if calibrate_head:
        calibrate_head_convs(system, images, generator)


# statistics of the head's output maps after calibrate_head_convs, (mean, std)
# over a batch, in map units: heatmap logits around the 0.1 score threshold
# (sigmoid(-2.197), 1.9 std above the mean, so ~3% of the map and a share of
# its peaks score above it, spread, not on it); box sizes (MonoFlex: the
# distances from the center to the box's sides) of a few stride-4 cells,
# dimensions around a car's metres, keypoints a few cells from their
# center; MonoFlex's depth logit around exp(-x) = 20 m and its log
# uncertainties around 0
HEAD_OUTPUT_STATS = {'hm': (-5.0, 1.5), 'hm_hp': (-5.0, 1.5), 'wh': (6.0, 2.0),
                     'hps': (0.0, 4.0), 'rot': (0.0, 1.0), 'dim': (2.0, 1.0),
                     'prob': (0.0, 1.0), 'reg': (0.5, 0.2), 'hp_offset': (0.5, 0.2),
                     'bbox2d': (4.0, 1.5), 'depth': (-3.0, 0.5),
                     'depth_uncertainty': (0.0, 0.5), 'corner_uncertainty': (0.0, 0.5)}


@torch.no_grad()
def calibrate_head_convs(system, images, generator: torch.Generator) -> None:
    """Give every ``{name}_out`` conv of the KM3D or MonoFlex head seeded weights scaled
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


def km3d_train_cfg(steps_per_epoch: int = 1) -> edict:
    """The optimizer and schedule of ``configs/km3d.py``: Adam, lr 1.25e-4,
    no weight decay, no clipping, MultiStepLR at epochs 90 and 120 (x0.1),
    stepped per epoch of ``steps_per_epoch`` updates."""
    return edict(
        optimizer=edict(type_name='adam', keywords=edict(lr=1.25e-4, weight_decay=0),
                        clipped_gradient_norm=None),
        scheduler=edict(type_name='MultiStepLR',
                        keywords=edict(milestones=[90, 120], gamma=0.1)),
        steps_per_epoch=steps_per_epoch,
    )


def monoflex_train_cfg(steps_per_epoch: int = 1) -> edict:
    """The optimizer and schedule of ``configs/monoflex.py``: Adam, lr 3e-4,
    no weight decay, gradients clipped to norm 35, MultiStepLR at epochs 60
    and 80 (x0.1), stepped per epoch of ``steps_per_epoch`` updates."""
    return edict(
        optimizer=edict(type_name='adam', keywords=edict(lr=3e-4, weight_decay=0),
                        clipped_gradient_norm=35.0),
        scheduler=edict(type_name='MultiStepLR',
                        keywords=edict(milestones=[60, 80], gamma=0.1)),
        steps_per_epoch=steps_per_epoch,
    )


def _synthetic_objects(rng: np.random.Generator, n: int, P2: np.ndarray, image_hw):
    """n Cars placed so that their projected 3-D boxes lie inside the
    image; the 2-D box is the projected corners' extent."""
    from visualdet3d_tpu_torch.data.kitti.dataset.km3d_dataset import (
        RTM3D_CORNERS, _project_corners)
    from visualdet3d_tpu_torch.data.kitti.kittidata import KittiObj
    from visualdet3d_tpu_torch.geometry import theta2alpha_3d
    h_img, w_img = image_hw
    objs = []
    while len(objs) < n:
        o = KittiObj()
        o.type, o.truncated, o.occluded = 'Car', 0.0, 0
        o.h, o.w, o.l = (float(v) for v in rng.normal((1.53, 1.63, 3.88), (0.1, 0.08, 0.3)))
        o.z = float(rng.uniform(8.0, 40.0))
        u = rng.uniform(0.15, 0.85) * w_img
        o.x = float((u - P2[0, 2]) * o.z / P2[0, 0] - P2[0, 3] / P2[0, 0])
        o.y = float(rng.normal(1.65, 0.1))
        o.ry = float(rng.uniform(-np.pi, np.pi))
        o.alpha = float(theta2alpha_3d(o.ry, o.x, o.z, P2))
        _, homo = _project_corners(P2, [o], RTM3D_CORNERS)
        uv = homo[0, :8, :2]
        if uv.min() < 1 or uv[:, 0].max() > w_img - 2 or uv[:, 1].max() > h_img - 2:
            continue
        o.bbox_l, o.bbox_t = float(uv[:, 0].min()), float(uv[:, 1].min())
        o.bbox_r, o.bbox_b = float(uv[:, 0].max()), float(uv[:, 1].max())
        objs.append(o)
    return objs


def _training_batch(builder, rng: np.random.Generator, batch_size: int, image_hw,
                    objects_per_image) -> dict:
    """Normal-noise images, the KITTI P2 scaled to ``image_hw``, a few Cars
    per image whose projected boxes lie inside it, and their targets from
    ``builder``, collated: ``{'images', 'P2', 'gts'}`` as numpy arrays."""
    P2 = KITTI_P2.copy()
    P2[0] *= image_hw[1] / KITTI_P2_HW[1]
    P2[1] *= image_hw[0] / KITTI_P2_HW[0]
    items = []
    for _ in range(batch_size):
        objs = _synthetic_objects(rng, int(rng.integers(*objects_per_image, endpoint=True)), P2,
                                  image_hw)
        image = rng.standard_normal((*image_hw, 3), dtype=np.float32)
        items.append({'image': image, 'calib': P2.copy(),
                      'label': builder.build_target(image_hw, P2, objs)})
    return builder.collate_fn(items)


def km3d_training_batch(rng: np.random.Generator, batch_size: int, image_hw,
                        objects_per_image=(2, 6), obj_types=('Car',), max_objects: int = 32):
    """A synthetic KM3D training batch (``_training_batch``) with targets
    from the ported KM3D target builder and ``collate_fn``."""
    from visualdet3d_tpu_torch.data.kitti.dataset.km3d_dataset import RTM3DTargetBuilder
    return _training_batch(RTM3DTargetBuilder(obj_types, max_objects), rng, batch_size,
                           image_hw, objects_per_image)


def monoflex_training_batch(rng: np.random.Generator, batch_size: int, image_hw,
                            objects_per_image=(2, 6), obj_types=('Car',),
                            max_objects: int = 32):
    """A synthetic MonoFlex training batch (``_training_batch``) with
    targets from the ported MonoFlex target builder."""
    from visualdet3d_tpu_torch.data.kitti.dataset.km3d_dataset import MonoFlexTargetBuilder
    return _training_batch(MonoFlexTargetBuilder(obj_types, max_objects), rng, batch_size,
                           image_hw, objects_per_image)
