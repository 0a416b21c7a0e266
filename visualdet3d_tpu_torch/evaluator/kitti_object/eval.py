"""Official KITTI object-detection AP evaluation, 40-point protocol
(counterpart of ``visualdet3d_tpu/evaluator/kitti_object/eval.py``).

Behavioural port of the reference evaluator
(visualDet3D/evaluator/kitti/eval.py:12-790): 2D bbox / BEV / 3D / AOS AP at
easy/moderate/hard under two overlap regimes, with the devkit's exact
ignore/DontCare semantics and greedy matching. The rotated overlap runs
through the port's clipping op in torch on the host (``rotate_iou.py``); the
greedy matcher is the C++ core (``csrc/kitti_eval.cpp``, ``native.py``),
built at first use. A failed build raises. The plain Python matcher,
``compute_statistics``, runs when the caller asks for it
(``matcher='python'``); it is the reference the native one is held to.
"""
from __future__ import annotations

import io as sysio

import numpy as np

from visualdet3d_tpu_torch.evaluator.kitti_object.rotate_iou import rotate_iou_eval


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = 41):
    """Pick ~41 score thresholds evenly covering the recall range
    (reference eval.py:12-31)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and \
                (i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting', 'car',
               'tractor', 'trailer']
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]


def clean_data(gt_anno: dict, dt_anno: dict, current_class: int, difficulty: int):
    """Difficulty/neighbor-class/DontCare filtering (reference eval.py:34-91).

    ignored flag: 0 = evaluate, 1 = ignore (neither tp nor fp), -1 = other class.
    """
    current_cls_name = CLASS_NAMES[current_class].lower()
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno['name'])):
        bbox = gt_anno['bbox'][i]
        gt_name = gt_anno['name'][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty] or
                  gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty] or
                  height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(len(dt_anno['name'])):
        valid_class = 1 if dt_anno['name'][i].lower() == current_cls_name else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """Axis-aligned overlap, vectorised (reference eval.py:93-120)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) -
          np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) -
          np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter = np.where((iw > 0) & (ih > 0), inter, 0.0)
    area_b = ((query_boxes[:, 2] - query_boxes[:, 0]) *
              (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    area_a = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a, inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = np.ones_like(inter)
    return np.where(inter > 0, inter / denom, 0.0)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    return rotate_iou_eval(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1, z_axis=1, z_center=1.0):
    """3D overlap = rotated BEV intersection x height overlap
    (reference eval.py:128-175)."""
    bev_axes = list(range(7))
    bev_axes.pop(z_axis + 3)
    bev_axes.pop(z_axis)
    rinc = rotate_iou_eval(boxes[:, bev_axes], qboxes[:, bev_axes], 2)
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return rinc
    min_z = np.minimum(
        boxes[:, None, z_axis] + boxes[:, None, z_axis + 3] * (1 - z_center),
        qboxes[None, :, z_axis] + qboxes[None, :, z_axis + 3] * (1 - z_center))
    max_z = np.maximum(
        boxes[:, None, z_axis] - boxes[:, None, z_axis + 3] * z_center,
        qboxes[None, :, z_axis] - qboxes[None, :, z_axis + 3] * z_center)
    iw = min_z - max_z
    vol_a = np.abs(boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = np.abs(qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = iw * rinc
    if criterion == -1:
        denom = vol_a + vol_b - inc
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inc.shape)
    elif criterion == 1:
        denom = np.broadcast_to(vol_b, inc.shape)
    else:
        denom = np.ones_like(inc)
    out = np.where((rinc > 0) & (iw > 0), inc / np.maximum(denom, 1e-12), 0.0)
    return out


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy per-image matching (reference eval.py:178-291 behavioural port).

    overlaps: [num_dt, num_gt].
    gt_datas: [num_gt, 5] (bbox, alpha); dt_datas: [num_dt, 6] (bbox, alpha, score).
    """
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [dt_scores[i] < thresh if compute_fp else False
                         for i in range(det_size)]
    NO_DETECTION = -10000000
    tp, fp, fn, similarity = 0, 0, 0, 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap and
                    dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap and
                  (overlap > max_overlap or assigned_ignored_det) and
                  ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap and
                  valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DETECTION and
              (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True
    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] in (-1, 1) or
                    ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1) or
                            ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt_annos[i], dt_annos[i], current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dontcares.append(np.stack(dc_bboxes, 0).astype(np.float64)
                         if dc_bboxes else np.zeros((0, 4)))
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt_annos[i]['bbox'], gt_annos[i]['alpha'][..., None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt_annos[i]['bbox'], dt_annos[i]['alpha'][..., None],
             dt_annos[i]['score'][..., None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
            total_num_valid_gt)


def _per_image_overlaps(gt_annos, dt_annos, metric, z_axis=1, z_center=1.0):
    """[num_dt, num_gt] overlap matrix per image."""
    overlaps = []
    bev_axes = list(range(3))
    bev_axes.pop(z_axis)
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(dt['bbox'], gt['bbox'])
        elif metric == 1:
            gt_boxes = np.concatenate(
                [gt['location'][:, bev_axes], gt['dimensions'][:, bev_axes],
                 gt['rotation_y'][..., None]], axis=1)
            dt_boxes = np.concatenate(
                [dt['location'][:, bev_axes], dt['dimensions'][:, bev_axes],
                 dt['rotation_y'][..., None]], axis=1)
            o = bev_box_overlap(dt_boxes, gt_boxes).astype(np.float64)
        elif metric == 2:
            gt_boxes = np.concatenate(
                [gt['location'], gt['dimensions'], gt['rotation_y'][..., None]], 1)
            dt_boxes = np.concatenate(
                [dt['location'], dt['dimensions'], dt['rotation_y'][..., None]], 1)
            o = d3_box_overlap(dt_boxes, gt_boxes, z_axis=z_axis,
                               z_center=z_center).astype(np.float64)
        else:
            raise ValueError('unknown metric')
        overlaps.append(o)
    return overlaps


MATCHERS = ('native', 'python')


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, z_axis=1, z_center=1.0,
               matcher: str = 'native'):
    """reference eval.py:476-595; returns precision/orientation tables.
    ``matcher``: 'native' (the C++ core) or 'python' (``compute_statistics``)."""
    if matcher not in MATCHERS:
        raise ValueError(f'matcher {matcher!r} is not one of {MATCHERS}')
    assert len(gt_annos) == len(dt_annos)
    N_SAMPLE_PTS = 41
    num_minoverlap = len(min_overlaps)
    precision = np.zeros([len(current_classes), len(difficultys),
                          num_minoverlap, N_SAMPLE_PTS])
    aos = np.zeros_like(precision)
    all_overlaps = _per_image_overlaps(gt_annos, dt_annos, metric, z_axis, z_center)

    native_lib = None
    if matcher == 'native':
        from visualdet3d_tpu_torch.evaluator.kitti_object.native import (PackedEvalData,
                                                                         load_library)
        native_lib = load_library()

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty)
            packed = None
            if native_lib is not None:
                packed = PackedEvalData(all_overlaps, gt_datas_list,
                                        dt_datas_list, ignored_gts,
                                        ignored_dets, dontcares)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                if packed is not None:
                    thresholdss = packed.collect_thresholds(
                        native_lib, metric, float(min_overlap)).tolist()
                else:
                    thresholdss = []
                    for i in range(len(gt_annos)):
                        _, _, _, _, th = compute_statistics(
                            all_overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=0.0,
                            compute_fp=False)
                        thresholdss += th.tolist()
                if total_num_valid_gt == 0:
                    continue
                thresholds = np.array(get_thresholds(
                    np.array(thresholdss), total_num_valid_gt))
                if packed is not None:
                    pr = packed.fused_statistics(native_lib, metric,
                                                 float(min_overlap), thresholds,
                                                 compute_aos)
                else:
                    pr = np.zeros([len(thresholds), 4])
                    for i in range(len(gt_annos)):
                        for t, thresh in enumerate(thresholds):
                            tp, fp, fn, similarity, _ = compute_statistics(
                                all_overlaps[i], gt_datas_list[i], dt_datas_list[i],
                                ignored_gts[i], ignored_dets[i], dontcares[i],
                                metric, min_overlap=min_overlap, thresh=thresh,
                                compute_fp=True, compute_aos=compute_aos)
                            pr[t, 0] += tp
                            pr[t, 1] += fp
                            pr[t, 2] += fn
                            if similarity != -1:
                                pr[t, 3] += similarity
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 1], 1e-12)
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / max(pr[i, 0] + pr[i, 1], 1e-12)
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {'precision': precision, 'orientation': aos,
            'min_overlaps': min_overlaps}


def get_mAP_v2(prec):
    """40-point AP in percent (reference eval.py:597-601)."""
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def do_eval_v3(gt_annos, dt_annos, current_classes, min_overlaps,
               compute_aos=False, difficultys=(0, 1, 2), z_axis=1, z_center=1.0,
               matcher: str = 'native'):
    types = ['bbox', 'bev', '3d']
    metrics = {}
    for i in range(3):
        metrics[types[i]] = eval_class(
            gt_annos, dt_annos, current_classes, difficultys, i, min_overlaps,
            compute_aos, z_axis=z_axis, z_center=z_center, matcher=matcher)
    return metrics


def print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


CLASS_TO_NAME = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                 4: 'Person_sitting', 5: 'car', 6: 'tractor', 7: 'trailer'}


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             difficultys=(0, 1, 2), z_axis=1, z_center=1.0,
                             matcher: str = 'native'):
    """reference eval.py:713-790; returns the formatted AP report string."""
    overlap_mod = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.7, 0.7]] * 3)
    overlap_easy = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5, 0.5, 0.5],
                             [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.5, 0.5],
                             [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.5, 0.5]])
    min_overlaps = np.stack([overlap_mod, overlap_easy], axis=0)
    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break
    metrics = do_eval_v3(gt_annos, dt_annos, current_classes, min_overlaps,
                         compute_aos, difficultys, z_axis=z_axis, z_center=z_center,
                         matcher=matcher)
    result = ''
    for j, curcls in enumerate(current_classes):
        for i in range(min_overlaps.shape[0]):
            mAPbbox = ', '.join(f'{v:.2f}' for v in
                                get_mAP_v2(metrics['bbox']['precision'][j, :, i]))
            mAPbev = ', '.join(f'{v:.2f}' for v in
                               get_mAP_v2(metrics['bev']['precision'][j, :, i]))
            mAP3d = ', '.join(f'{v:.2f}' for v in
                              get_mAP_v2(metrics['3d']['precision'][j, :, i]))
            result += print_str(
                f'{CLASS_TO_NAME[curcls]} AP(Average Precision)'
                '@{:.2f}, {:.2f}, {:.2f}:'.format(*min_overlaps[i, :, j]))
            result += print_str(f'bbox AP:{mAPbbox}')
            result += print_str(f'bev  AP:{mAPbev}')
            result += print_str(f'3d   AP:{mAP3d}')
            if compute_aos:
                mAPaos = ', '.join(
                    f'{v:.2f}' for v in
                    get_mAP_v2(metrics['bbox']['orientation'][j, :, i]))
                result += print_str(f'aos  AP:{mAPaos}')
    return result
