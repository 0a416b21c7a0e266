"""Top-level KITTI object evaluation entry (counterpart of
``visualdet3d_tpu/evaluator/kitti_object/evaluate.py``).

reference: visualDet3D/evaluator/kitti/evaluate.py:12-24 (minus the
numba.cuda device pinning: the overlaps run in torch on the host and the
matcher in C++).
"""
from __future__ import annotations

from typing import List

from visualdet3d_tpu_torch.evaluator.kitti_object.eval import get_official_eval_result
from visualdet3d_tpu_torch.evaluator.kitti_object.kitti_common import get_label_annos


def _read_imageset_file(path: str) -> List[int]:
    with open(path) as f:
        return [int(line) for line in f if line.strip()]


def evaluate(label_path: str, result_path: str, label_split_file: str,
             current_classes=(0,), gpu: int = 0) -> List[str]:
    """Evaluate result txts against GT labels; returns one report per class.
    ``gpu`` is the reference's device index, kept for its command line and
    unused."""
    dt_annos = get_label_annos(result_path)
    val_image_ids = _read_imageset_file(label_split_file)
    gt_annos = get_label_annos(label_path, val_image_ids)
    return [get_official_eval_result(gt_annos, dt_annos, c)
            for c in current_classes]
