"""Entry points of the port: the counterpart of ``__graft_entry__.entry()``.

``entry()`` returns ``(fn, example_args)``: YOLOStereo3D inference at the
KITTI benchmark resolution 288x1280 (ResNet-34 trunk with the s2d stem, the
CUDA correlation volumes, the concat volume, the pyramid, the 1408-channel
head, decode and NMS, all on the card). Weights are random, made from a
seed; the anchor priors are synthetic.

``build_int8_system()`` is the same Stereo3D in int8, as
``configs/stereo3d_int8.py`` runs it (``int8_all``): BN folded, activation
scales calibrated on two batches of two standard-normal image pairs, the
convs quantized; every selected conv on the CUDA int8 conv kernel, and with
``int8_block='pallas'`` layer1's three identity blocks on the fused int8
block kernel.

``build_stereo_trainer()`` is its training step (``configs/stereo3d.py``):
Adam, lr 1e-4, gradients clipped to global norm 0.1, CosineAnnealingLR over
80 epochs down to 5e-6; the detection loss plus the stereo focal
disparity loss of the train-only disparity head; f32 or bf16 mixed
precision; both correlation volumes' forward and backward on the CUDA
kernels.

``build_gac_system()`` is GAC monocular 3D detection
(``configs/yolo3d_gac.py``: ResNet-101 with the s2d stem to stride 16,
288x1280, 1024-channel features, a 512-wide class tower, 32 anchors a
location; Car and Pedestrian, as the JAX package's ``bench.py`` runs it)
with random weights from a seed: ``head='ground_aware'``
(``GroundAwareYolo3D``: ``LookGround``'s ground-aware sampling, then the
1024-wide regression tower) or ``head='dcn'`` (``Yolo3D``: the tower opens
with a 1024 -> 1024 modulated deformable conv on the CUDA kernels).
``build_gac_trainer()`` is its training step: Adam, lr 1e-4, gradients
clipped to global norm 0.1, CosineAnnealingLR over 30 epochs down to
3e-5, batch 8, f32 or bf16 mixed precision.

``build_km3d_system()`` is the KM3D system of ``configs/km3d.py`` (DLA-34,
the DCN neck on the CUDA deformable-conv kernel, ``head_features=256``) for
384x1280 images (``KM3D_IMAGE_HW``), random weights from a seed.

``build_km3d_trainer()`` is its training step: Adam, lr 1.25e-4,
MultiStepLR at epochs 90 and 120, f32 or bf16 mixed precision, every DCN's
forward and backward on the CUDA kernels.

``build_monoflex_system()`` and ``build_monoflex_trainer()`` are the same
for MonoFlex (``configs/monoflex.py``: the KM3D network with MonoFlex's head
branches, decode and loss; Adam, lr 3e-4, gradients clipped to norm 35,
MultiStepLR at epochs 60 and 80, batch 8).

``build_retinanet_system()`` and ``build_retinanet_trainer()`` are RetinaNet
2D detection (``configs/retinanet_2d.py``: ResNet-50 with the stem and
stage 1 frozen, FPN 256 with 5 levels, 4 stacked convs a tower, 9 anchors a
location, 384x1280; SGD, lr 0.01, momentum 0.9, weight decay 1e-4,
clipping at norm 35, MultiStepLR at epochs 20 and 26, batch 8).

``build_monodepth_system()`` and ``build_monodepth_trainer()`` are MonoDepth
(``configs/monodepth.py``: ResNet-34 and the U-Net decoder whose three
``DoubleConv`` blocks end in a DCN on the CUDA kernels, 352x1216; Adam, lr
1e-4, clipping at norm 0.1, ExponentialLR 0.98, batch 8).

Under ``VD3D_DCN_ALLTAPS=1`` and ``VD3D_DCN_PREMUL=1`` the DCNs take the
forward variants the JAX package's switches select
(``ops/deform_conv.forward_variant``).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Union

import torch

from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.ops.kernel_build import BUILD_DIR
from visualdet3d_tpu_torch.registry import DETECTOR_DICT
from visualdet3d_tpu_torch.testing import (
    KITTI_P2, calibrate_prediction_convs, gac_detector_cfg, gac_train_cfg,
    int8_calibration_batches, km3d_detector_cfg, km3d_train_cfg, monodepth_detector_cfg,
    monodepth_train_cfg, monoflex_detector_cfg, monoflex_train_cfg, retinanet_detector_cfg,
    retinanet_train_cfg, stereo3d_detector_cfg, stereo_train_cfg, write_synthetic_priors)

IMAGE_HW = (288, 1280)
KM3D_IMAGE_HW = (384, 1280)
RETINANET_IMAGE_HW = (384, 1280)
MONODEPTH_IMAGE_HW = (352, 1216)
KITTI_TRAIN_FRAMES = 3712  # the chen split's training frames (splits/chen_split/train.txt)
KITTI_DEPTH_TRAIN_FRAMES = 85898  # the frames of KITTI's depth-annotated training set
GAC_HEADS = {'ground_aware': 'GroundAwareYolo3D', 'dcn': 'Yolo3D'}


def build_system(depth: int = 34, device: Optional[Union[str, torch.device]] = None,
                 preprocessed: Optional[str] = None, training: bool = False):
    """The benchmark ``Stereo3D`` (Car, Pedestrian) with random weights from
    seed 0 on ``device`` (the card unless the caller names another).
    Synthetic priors go to ``preprocessed``, by default inside the package's
    build directory. ``training``: with the train-only disparity head."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers Stereo3D)

    device = resolve_device(device)
    if preprocessed is None:
        preprocessed = os.path.join(BUILD_DIR, 'priors')
    obj_types = ('Car', 'Pedestrian')
    write_synthetic_priors(preprocessed, obj_types, num_ratios=3)  # stereo ratios (0.5, 1, 2)
    cfg = stereo3d_detector_cfg(preprocessed, obj_types=obj_types, depth=depth)
    return DETECTOR_DICT[cfg.name](cfg, device=device, training=training)


def build_int8_system(int8_block=None, device: Optional[Union[str, torch.device]] = None):
    """:func:`build_system`'s Stereo3D (depth 34) ready for int8 ``predict``
    at 288x1280 on ``device`` (the card unless the caller names another).

    The zero-initialised prediction convs are seeded first
    (``testing.calibrate_prediction_convs`` on the first calibration batch,
    so that decode has detections); then, as the JAX package's ``bench.py``
    does: fold BN, ``int8_all``, calibrate on ``testing.int8_calibration_batches``
    (two batches of two pairs, ``default_rng(0)``, KITTI P2) on the system's
    device, quantize. ``int8_block`` is ``cfg.int8_block`` (None: every conv
    on its own; ``'pallas'``: the fused block kernel; ``'xla'``: the chain)."""
    device = resolve_device(device)
    system = build_system(device=device)
    batches = int8_calibration_batches(IMAGE_HW)
    calibrate_prediction_convs(system, batches[0][:2], torch.Generator().manual_seed(5))
    system.fold_inference_variables(IMAGE_HW)
    system.cfg.int8_all = True
    system.cfg.int8_block = int8_block
    system.quantize_int8(system.calibrate_int8(batches))
    system.cfg.inference_dtype = 'int8'
    return system


def build_gac_system(device: Optional[Union[str, torch.device]] = None,
                     head: str = 'ground_aware', preprocessed: Optional[str] = None):
    """GAC (``configs/yolo3d_gac.py``; Car, Pedestrian) with random weights
    from seed 0 on ``device`` (the card unless the caller names another):
    ``head='ground_aware'`` is ``GroundAwareYolo3D``, ``head='dcn'`` is
    ``Yolo3D``. Synthetic priors (16 scales x 2 ratios) go to
    ``preprocessed``, by default inside the package's build directory."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers the mono detectors)

    if head not in GAC_HEADS:
        raise ValueError(f'head {head!r}: one of {sorted(GAC_HEADS)}')
    device = resolve_device(device)
    if preprocessed is None:
        preprocessed = os.path.join(BUILD_DIR, 'priors_mono')
    obj_types = ('Car', 'Pedestrian')
    write_synthetic_priors(preprocessed, obj_types, num_ratios=2)
    cfg = gac_detector_cfg(preprocessed, obj_types=obj_types, name=GAC_HEADS[head])
    return DETECTOR_DICT[cfg.name](cfg, device=device)


def build_km3d_system(device: Optional[Union[str, torch.device]] = None):
    """The published KM3D (Car; DLA-34, ``head_features=256``, top-K 100)
    with random weights from seed 0 on ``device`` (the card unless the
    caller names another)."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers KM3D)

    device = resolve_device(device)
    cfg = km3d_detector_cfg()
    return DETECTOR_DICT[cfg.name](cfg, device=device)


def build_monoflex_system(device: Optional[Union[str, torch.device]] = None):
    """The published MonoFlex (Car; DLA-34, ``head_features=256``, top-K
    100) with random weights from seed 0 on ``device`` (the card unless the
    caller names another)."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers MonoFlex)

    device = resolve_device(device)
    cfg = monoflex_detector_cfg()
    return DETECTOR_DICT[cfg.name](cfg, device=device)


def build_retinanet_system(device: Optional[Union[str, torch.device]] = None):
    """RetinaNet of ``configs/retinanet_2d.py`` (Car, Pedestrian, Cyclist)
    with random weights from seed 0 on ``device`` (the card unless the
    caller names another)."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers RetinaNet)

    device = resolve_device(device)
    cfg = retinanet_detector_cfg()
    return DETECTOR_DICT[cfg.name](cfg, device=device)


def build_monodepth_system(device: Optional[Union[str, torch.device]] = None,
                           preprocessed: str = ''):
    """MonoDepth of ``configs/monodepth.py`` with random weights from seed 0
    on ``device`` (the card unless the caller names another); the prior
    mean from ``preprocessed`` (``cli/depth_precompute.py``'s files), else
    log 15 m."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers MonoDepth)

    device = resolve_device(device)
    cfg = monodepth_detector_cfg(preprocessed)
    return DETECTOR_DICT[cfg.name](cfg, device=device)


def _trainer(system, train_cfg, pipeline: str, compute_dtype: Optional[str]):
    """``(state, train_step)`` of the registered ``pipeline`` for ``system``
    with the optimizer and schedule of ``train_cfg``."""
    from visualdet3d_tpu_torch.pipelines import trainers  # noqa: F401  (registers the trainers)
    from visualdet3d_tpu_torch.pipelines.train_state import TrainState
    from visualdet3d_tpu_torch.registry import PIPELINE_DICT
    from visualdet3d_tpu_torch.solver.optimizers import build_optimizer

    state = TrainState(build_optimizer(system.net.parameters(), train_cfg.optimizer,
                                       train_cfg.scheduler, train_cfg.steps_per_epoch))
    return state, PIPELINE_DICT[pipeline](system, compute_dtype=compute_dtype)


def _check_batch_size(n: int, batch_size: int) -> None:
    if n != batch_size:
        raise ValueError(f'a batch of {n} images for a trainer whose epoch is counted in '
                         f'batches of {batch_size}')


def _rtm3d_trainer(system, train_cfg, compute_dtype: Optional[str], batch_size: int):
    """``(system, state, step)`` of the rtm3d trainer for ``system`` with the
    optimizer and schedule of ``train_cfg``."""
    state, train_step = _trainer(system, train_cfg, 'train_rtm3d', compute_dtype)

    def step(batch, epoch: float):
        _check_batch_size(batch['images'].shape[0], batch_size)
        return train_step(state, dict(batch, epoch=epoch))
    return system, state, step


def build_stereo_trainer(device: Optional[Union[str, torch.device]] = None,
                         compute_dtype: Optional[str] = None, batch_size: int = 16):
    """YOLOStereo3D training on ``device`` (the card unless the caller names
    another): returns ``(system, state, step)``. ``system`` is
    :func:`build_system`'s (ResNet-34, 288x1280) with the disparity head;
    ``state`` holds the optimizer of ``configs/stereo3d.py`` (an epoch is
    the chen split's training frames at ``batch_size``); ``step(batch)``
    takes ``{'left_images', 'right_images', 'P2', 'P3', 'annotations',
    'disparity'}`` (``testing.stereo_training_batch``) of ``batch_size``
    pairs, raising on another size, and makes one update in place,
    returning the loss terms. ``compute_dtype='bfloat16'`` is the
    mixed-precision policy (``pipelines/train_state.py``)."""
    cfg = stereo_train_cfg(steps_per_epoch=math.ceil(KITTI_TRAIN_FRAMES / batch_size))
    system = build_system(device=device, training=True)
    state, train_step = _trainer(system, cfg, 'train_stereo_detection', compute_dtype)

    def step(batch):
        _check_batch_size(batch['left_images'].shape[0], batch_size)
        return train_step(state, batch)
    return system, state, step


def build_gac_trainer(device: Optional[Union[str, torch.device]] = None,
                      compute_dtype: Optional[str] = None, batch_size: int = 8,
                      head: str = 'ground_aware'):
    """GAC training on ``device`` (the card unless the caller names
    another): returns ``(system, state, step)``. ``system`` is
    :func:`build_gac_system`'s (``head`` as there); ``state`` holds the
    optimizer of ``configs/yolo3d_gac.py`` (an epoch is the chen split's
    training frames at ``batch_size``, 8 in the config); ``step(batch)``
    takes ``{'images', 'P2', 'annotations'}`` (``testing.mono_training_batch``)
    of ``batch_size`` images, raising on another size, and makes one update
    in place, returning the loss terms. ``compute_dtype='bfloat16'`` is the
    mixed-precision policy (``pipelines/train_state.py``)."""
    cfg = gac_train_cfg(steps_per_epoch=math.ceil(KITTI_TRAIN_FRAMES / batch_size))
    system = build_gac_system(device=device, head=head)
    state, train_step = _trainer(system, cfg, 'train_mono_detection', compute_dtype)

    def step(batch):
        _check_batch_size(batch['images'].shape[0], batch_size)
        return train_step(state, batch)
    return system, state, step


def build_km3d_trainer(device: Optional[Union[str, torch.device]] = None,
                       compute_dtype: Optional[str] = None, batch_size: int = 16):
    """KM3D training on ``device`` (the card unless the caller names
    another): returns ``(system, state, step)``. ``system`` is
    :func:`build_km3d_system`'s; ``state`` holds the Adam optimizer of
    ``configs/km3d.py`` (an epoch is the chen split's training frames at
    ``batch_size``); ``step(batch, epoch)`` takes ``{'images', 'gts', 'P2'}``
    (``testing.km3d_training_batch``) of ``batch_size`` images, raising on
    another size, and makes one update in place, returning the loss terms.
    ``compute_dtype='bfloat16'`` is the mixed-precision policy
    (``pipelines/train_state.py``)."""
    cfg = km3d_train_cfg(steps_per_epoch=math.ceil(KITTI_TRAIN_FRAMES / batch_size))
    return _rtm3d_trainer(build_km3d_system(device), cfg, compute_dtype, batch_size)


def build_monoflex_trainer(device: Optional[Union[str, torch.device]] = None,
                           compute_dtype: Optional[str] = None, batch_size: int = 8):
    """MonoFlex training on ``device``, as :func:`build_km3d_trainer`:
    :func:`build_monoflex_system`'s system, the optimizer of
    ``configs/monoflex.py`` (Adam, lr 3e-4, clipping at norm 35, MultiStepLR
    at epochs 60 and 80), batches of ``batch_size`` images
    (``testing.monoflex_training_batch``)."""
    cfg = monoflex_train_cfg(steps_per_epoch=math.ceil(KITTI_TRAIN_FRAMES / batch_size))
    return _rtm3d_trainer(build_monoflex_system(device), cfg, compute_dtype, batch_size)


def build_retinanet_trainer(device: Optional[Union[str, torch.device]] = None,
                            compute_dtype: Optional[str] = None, batch_size: int = 8):
    """RetinaNet training on ``device`` (the card unless the caller names
    another): returns ``(system, state, step)``. ``system`` is
    :func:`build_retinanet_system`'s; ``state`` holds the SGD optimizer of
    ``configs/retinanet_2d.py`` (an epoch is the chen split's training
    frames at ``batch_size``); ``step(batch)`` takes ``{'images', 'P2',
    'annotations'}`` (``testing.mono_training_batch``) of ``batch_size``
    images, raising on another size, and makes one update in place,
    returning the loss terms. ``compute_dtype='bfloat16'`` is the
    mixed-precision policy (``pipelines/train_state.py``)."""
    cfg = retinanet_train_cfg(steps_per_epoch=math.ceil(KITTI_TRAIN_FRAMES / batch_size))
    system = build_retinanet_system(device)
    state, train_step = _trainer(system, cfg, 'train_2d_detection', compute_dtype)

    def step(batch):
        _check_batch_size(batch['images'].shape[0], batch_size)
        return train_step(state, batch)
    return system, state, step


def build_monodepth_trainer(device: Optional[Union[str, torch.device]] = None,
                            compute_dtype: Optional[str] = None, batch_size: int = 8):
    """MonoDepth training on ``device``, as :func:`build_retinanet_trainer`:
    :func:`build_monodepth_system`'s system, the optimizer of
    ``configs/monodepth.py`` (an epoch is KITTI's depth-annotated training
    frames at ``batch_size``), batches ``{'images', 'P2', 'gts'}``
    (``testing.depth_training_batch``); every DCN's forward and backward on
    the CUDA kernels."""
    cfg = monodepth_train_cfg(steps_per_epoch=math.ceil(KITTI_DEPTH_TRAIN_FRAMES / batch_size))
    system = build_monodepth_system(device)
    state, train_step = _trainer(system, cfg, 'train_mono_depth', compute_dtype)

    def step(batch):
        _check_batch_size(batch['images'].shape[0], batch_size)
        return train_step(state, batch)
    return system, state, step


def entry(device: Optional[Union[str, torch.device]] = None):
    """Flagship forward: YOLOStereo3D at 288x1280, depth 34, batch 1."""
    device = resolve_device(device)
    system = build_system(device=device)
    system.anchor_pack(IMAGE_HW)  # warm the anchor cache: fn is device work only

    def fn(left, right, P2):
        out = system.predict(left, right, P2, max_detections=32)
        return out['scores'], out['bboxes'], out['labels'], out['valid']

    left = torch.zeros((1, *IMAGE_HW, 3), device=device)
    right = torch.zeros((1, *IMAGE_HW, 3), device=device)
    P2 = torch.as_tensor(KITTI_P2, device=device)[None]
    return fn, (left, right, P2)
