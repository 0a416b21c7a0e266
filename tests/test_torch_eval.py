"""The port's KITTI evaluators, post-optimisation and testers against the
JAX package, on the CPU.

* ``rotate_iou_eval`` (criteria -1/0/1/2) and ``d3_box_overlap`` on seeded
  random boxes within 1e-5 of JAX's: the port clips in torch float32 on the
  host, JAX in XLA float32, in other orders;
* ``eval_class``'s precision and AOS tables (bbox, BEV, 3D) and
  ``get_official_eval_result``'s report equal to JAX's, exactly, on a
  seeded fixture of 24 frames of Cars, Vans, Pedestrians and a Cyclist
  with jittered, missed and false detections and DontCare regions; no
  overlap of the fixture lies within 1e-5 of a threshold (0.25, 0.5,
  0.7), so that exact equality is meaningful (asserted);
* the native matcher (``csrc/kitti_eval.cpp``, built from the port's own
  copy) equal to the Python matcher; a failed build raises;
* ``evaluate_depth`` equal to JAX's on seeded 16-bit PNGs; the label
  parser (the (l, h, w) reorder, the score column) and the evaluator's
  command line;
* ``convert_alpha_to_rot``, ``convert_rot_to_alpha``, ``back_projection``,
  ``hill_climb_batch`` and ``post_optimization`` equal to JAX's (numpy on
  both sides);
* the testers on one fake system's outputs: the trim, the Digging-M3D
  shifted copies; ``rescale_boxes_to_original`` and ``test_one``'s 2D
  branch (the crop-top rescale) line for line against JAX's;
* ``test_one`` of a tiny GAC with ``post_optimization`` (ResNet-18, 64x160)
  against JAX's with the same weights (the port's, bridged to flax): the
  same result lines and labels, numbers within the detectors' gates
  (``tests/test_torch_gac.py``: boxes rtol = atol = 1e-3).
"""
import copy
import types

import jax
import numpy as np
import pytest
import torch

from visualdet3d_tpu import geometry as jax_geometry
from visualdet3d_tpu.evaluator.kitti_depth import evaluate_depth as jax_depth
from visualdet3d_tpu.evaluator.kitti_object import eval as jax_eval
from visualdet3d_tpu.evaluator.kitti_object import kitti_common as jax_common
from visualdet3d_tpu.evaluator.kitti_object import rotate_iou as jax_rotate_iou
from visualdet3d_tpu.models.fast_utils import hill_climbing as jax_hill
from visualdet3d_tpu.pipelines import evaluators as jax_evaluators
from visualdet3d_tpu.pipelines import testers as jax_testers
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
import visualdet3d_tpu.models.detectors.yolo3d  # noqa: F401

import visualdet3d_tpu_torch.models  # noqa: F401
from visualdet3d_tpu_torch import geometry, testing
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.data.image_io import write_png
from visualdet3d_tpu_torch.evaluator import __main__ as evaluator_main
from visualdet3d_tpu_torch.evaluator.kitti_depth import evaluate_depth
from visualdet3d_tpu_torch.evaluator.kitti_object import eval as kitti_eval
from visualdet3d_tpu_torch.evaluator.kitti_object import kitti_common, rotate_iou
from visualdet3d_tpu_torch.models.fast_utils import hill_climbing
from visualdet3d_tpu_torch.ops import kernel_build
from visualdet3d_tpu_torch.pipelines import evaluators, testers
from visualdet3d_tpu_torch.registry import DETECTOR_DICT

from helpers import tiny_mono_cfg, write_fake_priors
from test_torch_gac import flax_from_port

THRESHOLDS = (0.25, 0.5, 0.7)
CLASSES = [0, 1, 2]  # Car, Pedestrian, Cyclist


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (the tier-1 run
    puts six workers on one machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- the fixture

SHAPES = {'Car': (1.52, 1.62, 3.9), 'Van': (2.1, 1.9, 4.8), 'Pedestrian': (1.75, 0.65, 0.85),
          'Cyclist': (1.7, 0.6, 1.75)}
P2 = testing.KITTI_CALIB['P2']


def _label_line(kind, x, y, z, ry, dims, occluded=0, truncated=0.0, score=None, jitter=None):
    """A KITTI label (or, with ``score``, result) line; the 2D box is the
    projected 3D box's extent, moved by ``jitter`` (4 px offsets)."""
    h, w, l = dims
    alpha = float(geometry.theta2alpha_3d(ry, x, z, P2))
    _, homo, _ = geometry.project_bbox3d(np.array([[x, y - h / 2, z, w, h, l, alpha]]), P2)
    box = np.concatenate([homo[0, :, :2].min(0), homo[0, :, :2].max(0)])
    if jitter is not None:
        box = box + jitter
    text = (f'{kind} {truncated:.2f} {occluded} {alpha:.4f} {box[0]:.2f} {box[1]:.2f} '
            f'{box[2]:.2f} {box[3]:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} '
            f'{ry:.4f}')
    return text if score is None else f'{text} {score:.4f}'


def _fixture_lines(n_frames=24, seed=3):
    """Per frame, (label lines, result lines): 2-5 objects a frame at 5-35 m
    (occlusion 0-2, some truncated), DontCare regions; each object detected
    with probability 0.8 (position, yaw and box jittered, a Van reported as
    a Car now and then), a false detection in half the frames."""
    rng = np.random.default_rng(seed)
    kinds = ('Car', 'Car', 'Car', 'Van', 'Pedestrian', 'Pedestrian', 'Cyclist')
    frames = []
    for _ in range(n_frames):
        gt, dt = [], []
        for _ in range(int(rng.integers(2, 6))):
            kind = kinds[int(rng.integers(len(kinds)))]
            dims = tuple(np.array(SHAPES[kind]) * rng.uniform(0.95, 1.05, 3))
            z = float(rng.uniform(5, 35))
            x = float(rng.uniform(-0.35, 0.35) * z)
            y, ry = float(rng.normal(1.65, 0.05)), float(rng.uniform(-np.pi, np.pi))
            gt.append(_label_line(kind, x, y, z, ry, dims, int(rng.integers(0, 3)),
                                  float(rng.choice([0.0, 0.0, 0.2, 0.4]))))
            if rng.random() < 0.8:
                name = 'Car' if kind == 'Van' and rng.random() < 0.5 else kind
                dt.append(_label_line(name, x + rng.normal(0, 0.25), y + rng.normal(0, 0.05),
                                      z + rng.normal(0, 0.6), ry + rng.normal(0, 0.25),
                                      tuple(np.array(dims) * rng.uniform(0.9, 1.1, 3)),
                                      score=float(rng.uniform(0.05, 1)),
                                      jitter=rng.normal(0, 4, 4)))
        if rng.random() < 0.5:
            z = float(rng.uniform(5, 35))
            dt.append(_label_line('Car', float(rng.uniform(-0.3, 0.3) * z), 1.65, z, 0.3,
                                  SHAPES['Car'], score=float(rng.uniform(0.05, 1))))
        gt.append('DontCare -1 -1 -10 500.00 160.00 560.00 200.00 -1 -1 -1 -1000 -1000 -1000 -10')
        frames.append((gt, dt))
    return frames


@pytest.fixture(scope='module')
def fixture_annos():
    frames = _fixture_lines()
    port = ([kitti_common.annotation_from_label_lines(g) for g, _ in frames],
            [kitti_common.annotation_from_label_lines(d) for _, d in frames])
    jax_side = ([jax_common.annotation_from_label_lines(g) for g, _ in frames],
                [jax_common.annotation_from_label_lines(d) for _, d in frames])
    return port, jax_side


def test_fixture_overlaps_avoid_the_thresholds(fixture_annos):
    """Exact equality of the tables means something only if no overlap of
    the fixture sits within 1e-5 of a threshold; and the fixture must have
    matches in every metric."""
    (gts, dts), _ = fixture_annos
    n_above = 0
    for metric in (0, 1, 2):
        for o in kitti_eval._per_image_overlaps(gts, dts, metric):
            dist = np.abs(o[..., None] - np.array(THRESHOLDS)).min(-1) if o.size else o
            assert not (dist < 1e-5).any(), (metric, o)
            n_above += int((o > 0.5).sum())
    assert n_above >= 60


@pytest.mark.parametrize('criterion', [-1, 0, 1, 2])
def test_rotate_iou_eval_matches_jax(criterion):
    rng = np.random.default_rng(5)

    def boxes(n):
        return np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(1, 4, (n, 2)),
                               rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    a, b = boxes(7), boxes(9)
    b[:3] = a[:3] + rng.normal(0, 0.2, (3, 5))  # overlapping pairs
    b[3] = a[3]  # identical
    got = rotate_iou.rotate_iou_eval(a, b, criterion)
    ref = jax_rotate_iou.rotate_iou_eval(a, b, criterion)
    assert got.shape == ref.shape == (7, 9) and got.dtype == np.float64
    assert (ref > 0).sum() >= 8
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert rotate_iou.rotate_iou_eval(a[:0], b, criterion).shape == (0, 9)


@pytest.mark.parametrize('criterion', [-1, 0, 1, 2])
def test_d3_box_overlap_matches_jax(criterion):
    rng = np.random.default_rng(6)

    def boxes(n):  # x, y, z, l, h, w, ry (the evaluator's layout)
        return np.concatenate([rng.uniform(-3, 3, (n, 1)), rng.uniform(1.4, 1.8, (n, 1)),
                               rng.uniform(10, 16, (n, 1)), rng.uniform(3.5, 4.5, (n, 1)),
                               rng.uniform(1.3, 1.7, (n, 1)), rng.uniform(1.5, 1.8, (n, 1)),
                               rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    a, b = boxes(6), boxes(8)
    b[:4] = a[:4] + rng.normal(0, 0.3, (4, 7))
    got = kitti_eval.d3_box_overlap(a, b, criterion)
    ref = jax_eval.d3_box_overlap(a, b, criterion)
    assert (ref > 0).sum() >= 4
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.fixture(scope='module')
def eval_tables(fixture_annos):
    """(port native, port python, JAX) eval_class results per metric, with
    the report's overlaps for Car, Pedestrian and Cyclist."""
    (gts, dts), (jgts, jdts) = fixture_annos
    overlaps = np.stack([np.array([[0.7, 0.5, 0.5]] * 3),
                         np.array([[0.7, 0.5, 0.5], [0.5, 0.25, 0.25], [0.5, 0.25, 0.25]])])
    out = {}
    for metric in (0, 1, 2):
        out[metric] = [kitti_eval.eval_class(gts, dts, CLASSES, (0, 1, 2), metric, overlaps,
                                             compute_aos=True, matcher=m)
                       for m in ('native', 'python')]
        out[metric].append(jax_eval.eval_class(jgts, jdts, CLASSES, (0, 1, 2), metric, overlaps,
                                               compute_aos=True))
    return out


@pytest.mark.parametrize('metric', [0, 1, 2])
def test_eval_class_tables_equal_jax(eval_tables, metric):
    native, _, ref = eval_tables[metric]
    for key in ('precision', 'orientation'):
        np.testing.assert_array_equal(native[key], ref[key])
    ap = jax_eval.get_mAP_v2(ref['precision'])
    assert (ap > 0).sum() >= 6 and (ap < 100).sum() >= 6  # neither empty nor perfect


@pytest.mark.parametrize('metric', [0, 1, 2])
def test_native_matcher_equals_python(eval_tables, metric):
    native, python, _ = eval_tables[metric]
    for key in ('precision', 'orientation'):
        np.testing.assert_array_equal(native[key], python[key])


def test_official_report_string_equals_jax(fixture_annos):
    (gts, dts), (jgts, jdts) = fixture_annos
    got = kitti_eval.get_official_eval_result(gts, dts, CLASSES)
    assert got == jax_eval.get_official_eval_result(jgts, jdts, CLASSES)
    assert got.count('AP(Average Precision)') == 6 and 'aos  AP:' in got


def test_unknown_matcher_raises(fixture_annos):
    (gts, dts), _ = fixture_annos
    with pytest.raises(ValueError, match='matcher'):
        kitti_eval.eval_class(gts, dts, [0], [0], 0, np.full((2, 3, 1), 0.7), matcher='numba')


def test_failed_native_build_raises(fixture_annos, monkeypatch, tmp_path):
    """No C++ compiler: the evaluator raises; it does not fall back to the
    Python matcher."""
    (gts, dts), _ = fixture_annos
    monkeypatch.setattr(kernel_build.shutil, 'which', lambda name: None)
    monkeypatch.delenv('CXX', raising=False)
    monkeypatch.setattr(kernel_build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(kernel_build, '_loaded', {})
    with pytest.raises(RuntimeError, match='no C\\+\\+ compiler found'):
        kitti_eval.get_official_eval_result(gts, dts, [0])
    assert list(tmp_path.iterdir()) == []
    (tmp_path / 'bad.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(kernel_build, 'CSRC_DIR', tmp_path)
    monkeypatch.setattr(kernel_build.shutil, 'which', lambda name: '/bin/false')
    with pytest.raises(RuntimeError, match='the compiler failed for csrc/bad.cpp'):
        kernel_build.load_host('bad')


def test_label_parser_equals_jax():
    lines = ['Car 0.10 1 -1.50 10.00 20.00 110.00 80.00 1.50 1.60 3.90 1.00 1.60 20.00 -1.45 0.75',
             'Pedestrian 0.00 0 0.20 200.00 90.00 230.00 170.00 1.70 0.60 0.80 -2.00 1.70 '
             '12.00 0.05 0.30']
    got = kitti_common.annotation_from_label_lines(lines)
    ref = jax_common.annotation_from_label_lines(lines)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got['dimensions'][0], [3.9, 1.5, 1.6])  # (l, h, w)
    np.testing.assert_array_equal(got['score'], [0.75, 0.3])
    np.testing.assert_array_equal(kitti_common.annotation_from_label_lines(lines[:1] * 2)['score'],
                                  [0.75, 0.75])
    assert kitti_common.annotation_from_label_lines([l[:-5] for l in lines])['score'].tolist() \
        == [0.0, 0.0]


def test_evaluator_command_line(tmp_path, capsys):
    """``python -m visualdet3d_tpu_torch.evaluator kitti_obj`` on files:
    the report of the ground truth written back as results."""
    (tmp_path / 'label').mkdir()
    (tmp_path / 'result').mkdir()
    frames = _fixture_lines(4, seed=8)
    for i, (gt, _) in enumerate(frames):
        (tmp_path / 'label' / f'{i + 10:06d}.txt').write_text('\n'.join(gt) + '\n')
        (tmp_path / 'result' / f'{i:06d}.txt').write_text(
            ''.join(f'{line} 1.0\n' for line in gt if not line.startswith('DontCare')))
    (tmp_path / 'val.txt').write_text(''.join(f'{i + 10:06d}\n' for i in range(4)))
    evaluator_main.main(['kitti_obj', f'--label_path={tmp_path / "label"}',
                         f'--result_path={tmp_path / "result"}',
                         f'--label_split_file={tmp_path / "val.txt"}', '--current_classes=0,1'])
    out = capsys.readouterr().out
    assert out.count('AP(Average Precision)') == 4 and 'Pedestrian AP' in out


def test_evaluate_depth_equals_jax(tmp_path):
    rng = np.random.default_rng(12)
    for sub in ('gt', 'pred'):
        (tmp_path / sub).mkdir()
    for i in range(3):
        gt = rng.integers(0, 80 * 256, (24, 40)).astype(np.uint16)
        gt[rng.random((24, 40)) < 0.6] = 0  # sparse ground truth
        pred = np.clip(gt.astype(np.float64) * rng.uniform(0.8, 1.2, gt.shape) + 256, 1,
                       65535).astype(np.uint16)
        write_png(str(tmp_path / 'gt' / f'{i:010d}.png'), gt)
        write_png(str(tmp_path / 'pred' / f'{i:010d}.png'), pred)
    got = evaluate_depth.evaluate_depth(str(tmp_path / 'gt'), str(tmp_path / 'pred'))
    assert got == jax_depth.evaluate_depth(str(tmp_path / 'gt'), str(tmp_path / 'pred'))
    assert len(got) == 9 and all(np.isfinite(float(s.split(':')[1])) for s in got)


# ------------------------------------------------- geometry, post-optimisation

def test_alpha_rot_conversions_and_back_projection_equal_jax():
    rng = np.random.default_rng(13)
    alpha = rng.uniform(-np.pi, np.pi, 64)
    cx = rng.uniform(0, 1280, 64)
    alpha[:2] = [np.pi, -np.pi]
    for port, ref in ((geometry.convert_alpha_to_rot, jax_geometry.convert_alpha_to_rot),
                      (geometry.convert_rot_to_alpha, jax_geometry.convert_rot_to_alpha)):
        np.testing.assert_array_equal(port(alpha, cx, P2), ref(alpha, cx, P2))
    state = np.concatenate([rng.uniform(0, 1280, (16, 1)), rng.uniform(0, 288, (16, 1)),
                            rng.uniform(5, 50, (16, 1)), rng.uniform(1, 4, (16, 3)),
                            rng.uniform(-3, 3, (16, 1))], axis=1)
    np.testing.assert_array_equal(geometry.back_projection(state, P2),
                                  jax_geometry.back_projection(state, P2))


def _refinable_detections(seed, n=12):
    """Car-like detections at 5-40 m whose 2D boxes are the projections of
    slightly other yaws, so that the hill climb has something to find; two
    Pedestrians and one Car at 2 m, which it leaves alone."""
    rng = np.random.default_rng(seed)
    states, boxes = [], []
    for i in range(n):
        z = 2.0 if i == 0 else rng.uniform(5, 40)
        x = rng.uniform(-0.3, 0.3) * z
        w, h, l = 1.6, 1.5, 3.9
        alpha = rng.uniform(-np.pi, np.pi)
        state = np.array([x, 1.65 - h / 2, z, w, h, l, alpha])
        truth = state.copy()
        truth[6] = alpha + rng.normal(0, 0.3)
        _, homo, _ = geometry.project_bbox3d(truth[None], P2)
        boxes.append(np.concatenate([homo[0, :, :2].min(0), homo[0, :, :2].max(0)]))
        states.append(state)
    names = ['Car'] * n
    names[3] = names[7] = 'Pedestrian'
    return np.array(boxes), np.array(states), names


def test_hill_climb_and_post_optimization_equal_jax():
    boxes, states, names = _refinable_detections(14)
    got = hill_climbing.post_optimization(boxes, states, P2, names)
    ref = jax_hill.post_optimization(boxes, states, P2, names)
    np.testing.assert_array_equal(got, ref)
    refined = got[:, 6] != states[:, 6]
    assert refined.sum() >= 6 and not refined[[0, 3, 7]].any()
    p2 = np.eye(4)
    p2[:3] = P2
    args = (p2, boxes, *states[:, :6].T, states[:, 6])
    for kw in ({}, dict(step_r_init=0.4, r_lim=0.01)):
        for port, ref in zip(hill_climbing.hill_climb_batch(*args, **kw),
                             jax_hill.hill_climb_batch(*args, **kw)):
            np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(
        hill_climbing.post_opt(boxes[1], states[1], P2, 640.0, 180.0),
        jax_hill.post_opt(boxes[1], states[1], P2, 640.0, 180.0))


# --------------------------------------------------------------- testers

def _fake_prediction(rng, n_valid=5, k=8, width=11):
    scores = np.sort(rng.uniform(0.3, 1.0, k))[::-1].astype(np.float32)
    bboxes = np.concatenate([rng.uniform(0, 200, (k, 4)), rng.uniform(0, 600, (k, 2)),
                             rng.uniform(5, 40, (k, 1)), rng.uniform(1, 4, (k, 3)),
                             rng.uniform(-3, 3, (k, 1))], axis=1)[:, :width].astype(np.float32)
    if width > 6:  # depths beyond 10 m but one: the shifted copies
        bboxes[:, 6] = rng.uniform(10.5, 40, k)
        bboxes[0, 6] = 8.0
    labels = rng.integers(0, 2, k)
    valid = np.arange(k) < n_valid
    return dict(scores=scores[None], bboxes=bboxes[None], labels=labels[None], valid=valid[None])


def _fake_systems(pred):
    """A port system and a JAX system whose ``predict`` returns ``pred``."""
    obj_types = ['Car', 'Pedestrian']
    port = types.SimpleNamespace(obj_types=obj_types, predict=lambda *a, **k: {
        key: torch.from_numpy(v) for key, v in pred.items()})
    ref = types.SimpleNamespace(obj_types=obj_types, predict=lambda *a, **k: pred)
    return port, ref


@pytest.mark.parametrize('tester', ['test_mono_detection', 'test_mono_detection_diggingmono3d'])
def test_mono_testers_equal_jax(tester):
    pred = _fake_prediction(np.random.default_rng(15))
    port, ref = _fake_systems(pred)
    batch = dict(images=np.zeros((1, 8, 8, 3), np.float32), P2=P2[None])
    got = getattr(testers, tester)(port)(batch)
    want = getattr(jax_testers, tester)(ref)(None, batch)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    n = 5 + 6 * 4 if tester.endswith('diggingmono3d') else 5  # 4 of the 5 beyond 10 m
    assert len(got[0]) == n


def test_stereo_tester_equals_jax():
    pred = _fake_prediction(np.random.default_rng(16), n_valid=0)
    port, ref = _fake_systems(pred)
    batch = dict(left_images=None, right_images=None, P2=P2[None])
    got = testers.test_stereo_detection(port)(batch)
    want = jax_testers.test_stereo_detection(ref)(None, batch)
    assert got[0].shape == want[0].shape == (0,) and got[1].shape == (0, 11) and got[2] == []


def test_rescale_boxes_to_original_equals_jax():
    rng = np.random.default_rng(17)
    boxes = rng.uniform(0, 300, (6, 4))
    small = P2.copy()
    small[0, :] *= 0.5
    small[1, :] *= 0.5
    small[1, 2] -= 40  # a crop of the top
    np.testing.assert_array_equal(evaluators.rescale_boxes_to_original(boxes, small, P2),
                                  jax_evaluators.rescale_boxes_to_original(boxes, small, P2))


class _FakeDataset:
    """One frame: an image, its P2, the original shape and P2, and the
    mono collate."""

    def __init__(self, image, P2_t, original_shape):
        self.item = dict(image=image, calib=P2_t, original_shape=original_shape,
                         original_P=P2.copy())

    def __len__(self):
        return 1

    def __getitem__(self, index):
        return copy.deepcopy(self.item)

    @staticmethod
    def collate_fn(batch):
        return dict(images=np.stack([b['image'] for b in batch]).astype(np.float32),
                    P2=np.stack([b['calib'] for b in batch]).astype(np.float32))


@pytest.mark.parametrize('crop_top', [None, 100])
def test_test_one_2d_branch_equals_jax(tmp_path, crop_top):
    """A 2D detector's boxes (4 columns) rescaled to the original image:
    ``crop_top`` from the config, else ``original_height -
    crop_top_height``."""
    pred = _fake_prediction(np.random.default_rng(18), width=4)
    port, ref = _fake_systems(pred)
    cfg = EasyDict(data=EasyDict(augmentation=EasyDict(crop_top=crop_top, crop_top_height=300)))
    dataset = _FakeDataset(np.zeros((96, 320, 3)), P2.copy(), (375, 1242, 3))
    for sub, fn, run in (('port', testers.test_mono_detection(port), evaluators.test_one),
                         ('jax', jax_testers.test_mono_detection(ref), None)):
        (tmp_path / sub).mkdir()
        if run is None:
            jax_evaluators.test_one(cfg, 0, dataset, None, fn, str(tmp_path / sub))
        else:
            run(cfg, 0, dataset, fn, str(tmp_path / sub))
    got = (tmp_path / 'port' / '000000.txt').read_text()
    assert got == (tmp_path / 'jax' / '000000.txt').read_text()
    assert got.count('\n') == int((pred['scores'][0, :5] >= 0.4).sum()) >= 2


# ------------------------------------------ test_one of a tiny GAC against JAX

TINY_HW = (64, 160)


def _result_rows(text):
    rows = [line.split() for line in text.splitlines()]
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:]] for r in rows])


@pytest.fixture(scope='module')
def gac_frames(tmp_path_factory):
    """A tiny GAC (ResNet-18, 64x160) with ``post_optimization``: the port's
    seeded weights (``prepare_mono_for_predict``, class logits shifted so
    that a tenth of the useful anchors score above 0.5) bridged to the JAX
    system; two frames of ``test_one`` on each side."""
    pre = str(tmp_path_factory.mktemp('pre'))
    write_fake_priors(pre, ['Car', 'Pedestrian'])
    det = tiny_mono_cfg(pre, obj_types=('Car', 'Pedestrian'), ground_aware=True)
    det.head.test_cfg.post_optimization = True
    det = EasyDict(copy.deepcopy(det))
    tsys = DETECTOR_DICT[det.name](copy.deepcopy(det), device='cpu')
    jsys = JAX_DETECTORS[det.name](copy.deepcopy(det))
    rng = np.random.default_rng(19)
    scale = TINY_HW[1] / 1242
    P2_t = P2.copy()
    P2_t[:2] *= scale
    P2_t[1, 2] -= 30 * scale
    images = rng.standard_normal((2, *TINY_HW, 3)).astype(np.float32)
    P2s = np.repeat(P2_t[None], 2, 0).astype(np.float32)
    testing.prepare_mono_for_predict(tsys, torch.from_numpy(images), torch.from_numpy(P2s),
                                     torch.Generator().manual_seed(20), offset_std=1.0)
    with torch.no_grad():
        cls = tsys.predict_raw(torch.from_numpy(images), torch.from_numpy(P2s))[0][..., 0]
        useful = tsys.anchors.useful_mask(tsys.anchor_pack(TINY_HW), torch.from_numpy(P2s))
        tsys.prediction_convs()[0].bias += 0.3 - torch.quantile(cls[useful], 0.9)
    tsys.weights_changed()
    shapes = jax.eval_shape(lambda k: jsys.init(k, TINY_HW, batch_size=1), jax.random.PRNGKey(0))
    variables = flax_from_port(shapes, tsys.net)
    jit_predict = jax.jit(jsys.predict, static_argnames='max_detections')
    jproxy = types.SimpleNamespace(obj_types=jsys.obj_types, predict=jit_predict)
    cfg = EasyDict(detector=det, data=EasyDict(augmentation=EasyDict()))
    out = {'port': [], 'jax': [], 'port_no_opt': []}
    for i in range(2):
        dataset = _FakeDataset(images[i], P2_t, (375, 1242, 3))
        for side in out:
            d = tmp_path_factory.mktemp(side)
            if side.startswith('port'):
                evaluators.test_one(cfg, 0, dataset, testers.test_mono_detection(tsys), str(d),
                                    post_opt_fn=None if side == 'port_no_opt' else
                                    hill_climbing.post_optimization)
            else:
                jax_evaluators.test_one(cfg, 0, dataset, variables,
                                        jax_testers.test_mono_detection(jproxy), str(d),
                                        post_opt_fn=jax_hill.post_optimization)
            out[side].append((d / '000000.txt').read_text())
    return out


def test_test_one_lines_equal_jax(gac_frames):
    """The same lines and labels; the 2D boxes, dimensions, locations,
    yaw, alpha and score within rtol = atol = 1e-3 (the detectors' box
    gate: the two networks sum their convs in other orders)."""
    n_lines = 0
    for got, ref in zip(gac_frames['port'], gac_frames['jax']):
        names, vals = _result_rows(got)
        ref_names, ref_vals = _result_rows(ref)
        assert names == ref_names
        n_lines += len(names)
        if names:
            np.testing.assert_allclose(vals, ref_vals, rtol=1e-3, atol=1e-3)
    assert n_lines >= 2


def test_test_one_post_optimization_refines_a_car(gac_frames):
    """The hill climb moved at least one Car's alpha (and so its yaw): the
    frames written without it differ in those two columns only, and only
    on Cars."""
    names, vals = _result_rows(''.join(gac_frames['port']))
    plain_names, plain = _result_rows(''.join(gac_frames['port_no_opt']))
    assert names == plain_names
    moved = np.abs(vals - plain) > 0  # columns: truncation, occlusion, alpha, box, hwl, xyz, ry, score
    assert not moved[:, [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14]].any()
    assert moved[:, 2].sum() >= 1 and all(names[i] == 'Car' for i in np.flatnonzero(moved[:, 2]))
