"""Registered inference pipelines, one frame at a time (counterpart of
``visualdet3d_tpu/pipelines/testers.py``; reference
visualDet3D/networks/pipelines/testers.py:15-91).

Each factory takes a detector system, which holds its weights, and returns
``fn(batch) -> (scores [N], bboxes [N, C], names)``: numpy arrays trimmed to
the valid detections of the batch's first image. Decode and NMS run on the
system's device inside ``predict``; the outputs come to the host in one
copy. The depth-shift score augmentation of Digging_M3D (testers.py:44-90)
is reproduced host-side on the decoded boxes. ``test_mono_depth`` returns
MonoDepth's dense prediction as it is, on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from visualdet3d_tpu_torch.registry import PIPELINE_DICT


def _trim(prediction, obj_types):
    """The first image's valid detections of a ``predict`` output, copied
    to the host at once (scores, boxes, labels and the valid flags packed
    into one float32 tensor: labels are small integers, exact in f32)."""
    scores = prediction['scores'][0].float()
    bboxes = prediction['bboxes'][0].float()
    packed = torch.cat([scores[:, None], bboxes, prediction['labels'][0].float()[:, None],
                        prediction['valid'][0].float()[:, None]], dim=1).cpu().numpy()
    packed = packed[packed[:, -1] > 0.5]
    names = [obj_types[int(i)] for i in packed[:, -2]]
    return packed[:, 0], packed[:, 1:-2], names


@PIPELINE_DICT.register_module
def test_mono_detection(system, max_detections: int = 64):
    """reference testers.py:15: batch = dict(images, P2)."""
    def fn(batch):
        pred = system.predict(batch['images'], batch['P2'], max_detections=max_detections)
        return _trim(pred, system.obj_types)
    return fn


@PIPELINE_DICT.register_module
def test_stereo_detection(system, max_detections: int = 64):
    """reference testers.py:30: batch = dict(left_images, right_images, P2[, P3])."""
    def fn(batch):
        pred = system.predict(batch['left_images'], batch['right_images'], batch['P2'],
                              batch.get('P3'), max_detections=max_detections)
        return _trim(pred, system.obj_types)
    return fn


@PIPELINE_DICT.register_module
def test_mono_detection_diggingmono3d(system, max_detections: int = 64,
                                      lamda: float = 80.0):
    """Digging-into-M3D test-time depth-shift score augmentation
    (reference testers.py:44-90): each detection deeper than 10 m spawns
    shifted copies at z + {-2,-1,-0.5,0.5,1,2} with Gaussian-discounted
    scores."""
    base = test_mono_detection(system, max_detections)

    def fn(batch):
        scores, bboxes, names = base(batch)
        if len(scores) == 0:
            return scores, bboxes, names
        out_s, out_b, out_n = [], [], []
        for i in range(len(scores)):
            out_s.append(scores[i])
            out_b.append(bboxes[i])
            out_n.append(names[i])
            depth = bboxes[i, 6]
            if depth < 10:
                continue
            sigma = np.exp(depth / lamda)
            for shift in (-2, -1, -0.5, 0.5, 1, 2):
                nb = bboxes[i].copy()
                nb[6] = depth + shift
                out_s.append(scores[i] * np.exp(-shift ** 2 / sigma ** 2))
                out_b.append(nb)
                out_n.append(names[i])
        return np.asarray(out_s), np.stack(out_b), out_n
    return fn


@PIPELINE_DICT.register_module
def test_mono_depth(system):
    """Dense depth prediction (``evaluate_kitti_depth``'s): batch =
    dict(images, P2) -> ``system.predict``'s dict(target [B, H, W, 1])."""
    def fn(batch):
        return system.predict(batch['images'], batch['P2'])
    return fn
