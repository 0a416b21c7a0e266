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
    KITTI_P2, calibrate_prediction_convs, int8_calibration_batches, km3d_detector_cfg,
    km3d_train_cfg, monoflex_detector_cfg, monoflex_train_cfg, stereo3d_detector_cfg,
    write_synthetic_priors)

IMAGE_HW = (288, 1280)
KM3D_IMAGE_HW = (384, 1280)
KITTI_TRAIN_FRAMES = 3712  # the chen split's training frames (splits/chen_split/train.txt)


def build_system(depth: int = 34, device: Optional[Union[str, torch.device]] = None,
                 preprocessed: Optional[str] = None):
    """The benchmark ``Stereo3D`` (Car, Pedestrian) with random weights from
    seed 0 on ``device`` (the card unless the caller names another).
    Synthetic priors go to ``preprocessed``, by default inside the package's
    build directory."""
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers Stereo3D)

    device = resolve_device(device)
    if preprocessed is None:
        preprocessed = os.path.join(BUILD_DIR, 'priors')
    obj_types = ('Car', 'Pedestrian')
    write_synthetic_priors(preprocessed, obj_types, num_ratios=3)  # stereo ratios (0.5, 1, 2)
    cfg = stereo3d_detector_cfg(preprocessed, obj_types=obj_types, depth=depth)
    return DETECTOR_DICT[cfg.name](cfg, device=device)


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
    calibrate_prediction_convs(system, batches[0][0], batches[0][1],
                               torch.Generator().manual_seed(5))
    system.fold_inference_variables(IMAGE_HW)
    system.cfg.int8_all = True
    system.cfg.int8_block = int8_block
    system.quantize_int8(system.calibrate_int8(batches))
    system.cfg.inference_dtype = 'int8'
    return system


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


def _rtm3d_trainer(system, train_cfg, compute_dtype: Optional[str], batch_size: int):
    """``(system, state, step)`` of the rtm3d trainer for ``system`` with the
    optimizer and schedule of ``train_cfg``."""
    from visualdet3d_tpu_torch.pipelines import trainers  # noqa: F401  (registers train_rtm3d)
    from visualdet3d_tpu_torch.pipelines.train_state import TrainState
    from visualdet3d_tpu_torch.registry import PIPELINE_DICT
    from visualdet3d_tpu_torch.solver.optimizers import build_optimizer

    state = TrainState(build_optimizer(system.net.parameters(), train_cfg.optimizer,
                                       train_cfg.scheduler, train_cfg.steps_per_epoch))
    train_step = PIPELINE_DICT['train_rtm3d'](system, compute_dtype=compute_dtype)

    def step(batch, epoch: float):
        n = batch['images'].shape[0]
        if n != batch_size:
            raise ValueError(f'a batch of {n} images for a trainer whose epoch is counted in '
                             f'batches of {batch_size}')
        return train_step(state, dict(batch, epoch=epoch))
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
