"""Registered training pipelines (counterpart of
``visualdet3d_tpu/pipelines/trainers.py``). The rtm3d trainer is ported;
the detection, stereo and depth trainers come with their slices."""
from __future__ import annotations

from visualdet3d_tpu_torch.pipelines.train_state import make_simple_train_step
from visualdet3d_tpu_torch.registry import PIPELINE_DICT


@PIPELINE_DICT.register_module
def train_rtm3d(system, **kwargs):
    """KM3D/RTM3D: batch = dict(images, gts, P2[, epoch])."""
    return make_simple_train_step(system, batch_keys=('images', 'gts', 'P2'), **kwargs)
