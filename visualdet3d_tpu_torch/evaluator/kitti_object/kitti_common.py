"""KITTI label/result txt parsing into annotation dicts (counterpart of
``visualdet3d_tpu/evaluator/kitti_object/kitti_common.py``).

reference: visualDet3D/evaluator/kitti/kitti_common.py (itself the standard
KITTI devkit port). Annotation dict keys: name, truncated, occluded, alpha,
bbox [N,4], dimensions [N,3] (l, h, w), location [N,3], rotation_y [N],
score [N].
"""
from __future__ import annotations

import os
import pathlib
import re
from typing import List, Optional

import numpy as np


def get_image_index_str(img_idx) -> str:
    return '%06d' % int(img_idx)


def annotation_from_label_lines(lines: List[str]) -> dict:
    content = [line.strip().split(' ') for line in lines if line.strip()]
    annotations = {}
    annotations['name'] = np.array([x[0] for x in content])
    annotations['truncated'] = np.array([float(x[1]) for x in content])
    annotations['occluded'] = np.array([int(float(x[2])) for x in content])
    annotations['alpha'] = np.array([float(x[3]) for x in content])
    annotations['bbox'] = np.array(
        [[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4)
    # file stores h, w, l; reorder to (l, h, w) so dims align with (x, y, z)
    annotations['dimensions'] = np.array(
        [[float(v) for v in x[8:11]] for x in content]).reshape(-1, 3)[:, [2, 0, 1]]
    annotations['location'] = np.array(
        [[float(v) for v in x[11:14]] for x in content]).reshape(-1, 3)
    annotations['rotation_y'] = np.array([float(x[14]) for x in content]).reshape(-1)
    if content and len(content[0]) == 16:
        annotations['score'] = np.array([float(x[15]) for x in content])
    else:
        annotations['score'] = np.zeros((annotations['bbox'].shape[0],))
    return annotations


def get_label_anno(label_path: str) -> dict:
    with open(label_path) as f:
        lines = f.readlines()
    return annotation_from_label_lines(lines)


def get_label_annos(label_folder: str,
                    image_ids: Optional[List] = None) -> List[dict]:
    if image_ids is None:
        filepaths = pathlib.Path(label_folder).glob('*.txt')
        prog = re.compile(r'^\d{6}.txt$')
        image_ids = sorted(int(p.name[:6]) for p in filepaths if prog.match(p.name))
    annos = []
    for idx in image_ids:
        image_idx = get_image_index_str(idx) if not isinstance(idx, str) else idx
        annos.append(get_label_anno(os.path.join(label_folder, image_idx + '.txt')))
    return annos
