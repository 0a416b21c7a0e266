"""The anchor-based 3D detector system base (counterpart of ``Yolo3DSystem``
in ``visualdet3d_tpu/models/detectors/yolo3d.py``).

A system holds the network (an ``nn.Module`` with its weights, on the
system's device), the anchors and their priors, and the decode + NMS that
turns raw predictions into a fixed number of detections per image. The
monocular ``Yolo3D``/``GroundAwareYolo3D`` networks come with the GAC slice
of the port; this base carries what the stereo system shares with them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from visualdet3d_tpu_torch.device import resolve_device
from visualdet3d_tpu_torch.models.heads import detection_3d_head as head_lib
from visualdet3d_tpu_torch.models.heads.anchors import Anchors
from visualdet3d_tpu_torch.models.quant import InferenceMixin


class Yolo3DSystem(InferenceMixin):
    """Config-built detector system.

    ``cfg.inference_dtype = 'bfloat16'`` runs the network in bf16 (decode
    and NMS stay f32, the logits stay bf16 until the top-K gather), as the
    JAX package's ``_inference_cast`` does; ``'int8'`` runs the int8 copy of
    the folded network (``models/quant.py``: ``fold_inference_variables``,
    ``calibrate_int8``, ``quantize_int8``) with a bf16 remainder.
    """

    def __init__(self, network_cfg, device: Optional[Union[str, torch.device]] = None):
        self.cfg = network_cfg
        self.device = resolve_device(device)
        self.obj_types = list(network_cfg.obj_types)
        self.num_classes = len(self.obj_types)

        head_cfg = network_cfg.head
        anchors_cfg = dict(head_cfg.anchors_cfg)
        anchors_cfg.pop('obj_types', None)
        self.anchors = Anchors(
            preprocessed_path=head_cfg.get('preprocessed_path', ''),
            obj_types=self.obj_types,
            read_config_file=head_cfg.get('read_precompute_anchor', True),
            **anchors_cfg)
        self.loss_cfg = head_cfg.loss_cfg
        self.test_cfg = head_cfg.test_cfg
        self.layer_cfg = head_cfg.layer_cfg
        self.num_regression_loss_terms = head_cfg.get('num_regression_loss_terms', 13)

        self._anchor_cache: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._init_inference_cache()

    # -------------------------------------------------------------- helpers
    def anchor_pack(self, image_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """The anchors of an image shape as tensors on the system's device."""
        key = tuple(image_hw)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = {
                k: torch.as_tensor(v, device=self.device)
                for k, v in self.anchors.get(key).items()}
        return self._anchor_cache[key]

    def decode(self, cls_preds, reg_preds, P2, image_hw, max_detections: int = 32,
               default_nms_iou_thr: float = 0.5):
        """Raw predictions -> dict(scores [B,K], bboxes [B,K,11], labels
        [B,K], valid [B,K]), K = max_detections."""
        pack = self.anchor_pack(image_hw)
        is_filtering = self.test_cfg.get(
            'filter_anchor', self.loss_cfg.get('filter_anchor', True))
        if is_filtering:
            useful = self.anchors.useful_mask(pack, P2)
        else:
            useful = torch.ones((P2.shape[0], pack['anchors'].shape[0]),
                                dtype=torch.bool, device=P2.device)
        scores, bboxes, labels, valid = head_lib.get_bboxes_batched(
            cls_preds, reg_preds, self.anchors.num_anchors,
            pack['anchors'], pack['anchor_mean_std'], useful,
            num_classes=self.num_classes,
            image_hw=image_hw,
            score_thr=self.test_cfg.get('score_thr', 0.75),
            nms_iou_thr=self.test_cfg.get('nms_iou_thr', default_nms_iou_thr),
            max_detections=max_detections,
            # the reference reads the misspelt key, so its NMS is class-agnostic
            cls_agnostic=self.test_cfg.get('cls_agnositc', True),
        )
        return dict(scores=scores, bboxes=bboxes, labels=labels, valid=valid)
