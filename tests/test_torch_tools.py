"""The tools of the PyTorch port (slice A7) against the JAX package and,
where the JAX package calls it, OpenCV:

* ``ops/stereo_bm.py``'s plain version against ``cv2.StereoBM_create(192,
  25).compute``, bit for bit, and ``data/cv_ops.rgb_to_gray`` against
  ``cv2.cvtColor``;
* ``cli/imdb_precompute_test.py`` against the JAX ``run``: equal records,
  and each package's ``KittiStereoTestDataset`` reads the other's pickle;
* ``utils/visualization.py`` against the JAX ``draw_3d_box`` (``cv2.line``)
  and ``cv2.rectangle``, pixel for pixel, and ``cli/demo.render`` against
  the JAX demo's drawing (less its text);
* the new CLIs' refusal to fall back to the CPU.

Torch runs on one intra-op thread (the tier-1 run puts six workers on one
machine).
"""
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

import visualdet3d_tpu.data  # noqa: F401  (registers the JAX datasets)
from visualdet3d_tpu import geometry as jgeometry
from visualdet3d_tpu.cli import imdb_precompute_test as jax_imdb_test
from visualdet3d_tpu.config import cfg_from_file as jax_cfg_from_file
from visualdet3d_tpu.registry import DATASET_DICT as JAX_DATASETS
from visualdet3d_tpu.utils.visualization import draw_3d_box as jax_draw_3d_box

import visualdet3d_tpu_torch.data  # noqa: F401  (registers the port's datasets)
from visualdet3d_tpu_torch import testing
from visualdet3d_tpu_torch.cli import demo
from visualdet3d_tpu_torch.cli import imdb_precompute_test as port_imdb_test
from visualdet3d_tpu_torch.config import cfg_from_file
from visualdet3d_tpu_torch.data import cv_ops
from visualdet3d_tpu_torch.ops import stereo_bm as sb
from visualdet3d_tpu_torch.registry import DATASET_DICT as PORT_DATASETS
from visualdet3d_tpu_torch.utils import visualization as vz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ StereoBM


def _pair(case, rng):
    """(left, right) numpy arrays, maybe views that are not contiguous."""
    if case == 'shifted':
        return testing.stereo_grey_pair(rng, (96, 400), 3)
    if case == 'mirrored_views':  # the right eye's call: the mirrored pair
        left, right = testing.stereo_grey_pair(rng, (80, 360), 3)
        return right[:, ::-1], left[:, ::-1]
    if case == 'flat_repeated':
        return testing.stereo_grey_pair(rng, (90, 420), 3, flat=True)
    if case == 'noise':
        return (rng.integers(0, 256, (72, 300), np.uint8),
                rng.integers(0, 256, (72, 300), np.uint8))
    if case == 'narrow_odd':  # 192 + 25 + 2 columns, an odd height
        return testing.stereo_grey_pair(rng, (61, 219), 3)
    return testing.stereo_grey_pair(rng, (288, 1280), 3)  # 'full': the stereo config's maps


@pytest.mark.parametrize('case', ['shifted', 'mirrored_views', 'flat_repeated', 'noise',
                                  'narrow_odd', 'full'])
def test_stereo_bm_matches_opencv(case):
    """The plain version equals ``cv2.StereoBM_create(192, 25).compute`` bit
    for bit: disparities x16, -16 where filtered (the border, the texture
    and uniqueness checks)."""
    left, right = _pair(case, np.random.default_rng(['shifted', 'mirrored_views',
                                                     'flat_repeated', 'noise', 'narrow_odd',
                                                     'full'].index(case)))
    ref = cv2.StereoBM_create(192, 25).compute(np.ascontiguousarray(left),
                                               np.ascontiguousarray(right))
    lt, rt = torch.from_numpy(left.copy()), torch.from_numpy(right.copy())
    if case == 'mirrored_views':  # views the wrapper reads by their strides
        lt = lt.t().contiguous().t()
        rt = torch.from_numpy(np.repeat(right, 2, axis=1))[:, ::2]
        assert not lt.is_contiguous() and not rt.is_contiguous()
    out = sb.stereo_bm(lt, rt)
    assert out.dtype == torch.int16 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    valid = ref != sb.FILTERED
    if case in ('shifted', 'mirrored_views', 'full'):
        assert valid.mean() > 0.2
    if case == 'flat_repeated':  # the flat third filtered by the texture check
        assert not valid[:, 12: 420 // 3 - 12].any()


def test_rgb_to_gray_matches_opencv():
    """``cv_ops.rgb_to_gray`` equals ``cvtColor(RGB2GRAY)`` at every one of
    the 2^24 RGB triples (0 and 255 among them)."""
    levels = np.arange(256, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(levels, levels, levels, indexing='ij'), -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(cv_ops.rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


# ----------------------------------------------------------------- test split


def test_imdb_precompute_test_matches_jax(tmp_path, monkeypatch):
    """The test split's records equal the JAX ``run``'s (calib arrays
    exactly, the paths, ``label == []``), and each package's
    ``KittiStereoTestDataset`` reads the other's pickle."""
    monkeypatch.setenv('VD3D_WORKDIR', str(tmp_path / 'workdirs'))
    root = testing.write_synthetic_kitti(str(tmp_path / 'testing'), 3, seed=4)
    os.remove(os.path.join(root, 'calib', '000001.txt'))  # a frame without calib is skipped
    config = tmp_path / 'cfg.py'
    pre = {name: str(tmp_path / f'pre_{name}') for name in ('jax', 'port')}
    for name in ('jax', 'port'):
        config.write_text(
            'from visualdet3d_tpu.config import cfg_from_file\n'
            f'cfg = cfg_from_file({os.path.join(ROOT, "configs", "stereo3d.py")!r})\n'
            f'cfg.path.test_path = {root!r}\n'
            f'cfg.path.preprocessed_path = {pre[name]!r}\n')
        if name == 'jax':
            jax_imdb_test.run(str(config))
        else:
            port_cfg = cfg_from_file(str(config))
            port_imdb_test.run(port_cfg)
    records = {}
    for name in ('jax', 'port'):
        with open(os.path.join(pre[name], 'test', 'imdb.pkl'), 'rb') as f:
            records[name] = pickle.load(f)
    assert [r['index'] for r in records['port']] == ['000000', '000002']
    for a, b in zip(records['jax'], records['port'], strict=True):
        assert a.keys() == b.keys()
        assert b['label'] == [] == a['label']
        for key in ('index', 'image_2_path', 'image_3_path', 'velodyne_path'):
            assert a[key] == b[key]
        for key, value in a['calib'].items():
            assert b['calib'][key].dtype == value.dtype
            np.testing.assert_array_equal(b['calib'][key], value)
    # each package's dataset on the other's pickle
    for reader, datasets, other in (('port', PORT_DATASETS, 'jax'), ('jax', JAX_DATASETS, 'port')):
        cfg = port_cfg if reader == 'port' else jax_cfg_from_file(str(config))
        cfg.path.preprocessed_path = pre[other]
        dataset = datasets['KittiStereoTestDataset'](cfg, 'test')
        assert len(dataset) == 2
        item = dataset[1]
        assert item['image'][0].shape == (288, 1280, 3)
        np.testing.assert_array_equal(item['original_P'], records[other][1]['calib']['P2'])


# ------------------------------------------------------------------- drawing


def _corners(rng, kind, hw):
    """[3, 8] projected corners of a box: inside the image, partly outside,
    wholly outside, or degenerate (two corners equal)."""
    h, w = hw
    if kind == 'inside':
        c = rng.uniform([0, 0], [w - 1, h - 1], (8, 2))
    elif kind == 'partly_outside':
        c = rng.uniform([-w / 2, -h / 2], [1.5 * w, 1.5 * h], (8, 2))
    elif kind == 'outside':
        c = rng.uniform([w + 10, -3 * h], [3 * w, -10], (8, 2))
    else:
        c = rng.uniform([0, 0], [w - 1, h - 1], (8, 2))
        c[3] = c[2]
        c[6] = c[7]
    return np.concatenate([c.T, np.ones((1, 8))]).astype(np.float32)


def test_draw_3d_box_matches_jax():
    """The wireframe equals the JAX package's (``cv2.line`` at thickness 2
    and 1) pixel for pixel on 40 random boxes of each kind."""
    rng = np.random.default_rng(7)
    hw = (96, 320)
    for kind in ('inside', 'partly_outside', 'outside', 'degenerate'):
        for i in range(40):
            corners = _corners(rng, kind, hw)
            base = rng.integers(0, 256, (*hw, 3), np.uint8)
            ref = jax_draw_3d_box(base.copy(), corners)
            out = vz.draw_3d_box(base.copy(), corners)
            assert np.array_equal(out, ref), (kind, i)
            if kind == 'inside':
                assert (out != base).any()


def test_draw_rectangle_matches_opencv():
    """``draw_rectangle`` equals ``cv2.rectangle(..., thickness)`` at
    thickness 1, 2 and 3, corners inside, outside and crossed."""
    rng = np.random.default_rng(8)
    hw = (80, 200)
    for i in range(120):
        p1 = tuple(int(v) for v in rng.integers(-40, 240, 2))
        p2 = tuple(int(v) for v in rng.integers(-40, 240, 2))
        thickness = 1 + i % 3
        base = rng.integers(0, 256, (*hw, 3), np.uint8)
        ref = cv2.rectangle(base.copy(), p1, p2, (0, 255, 0), thickness)
        out = vz.draw_rectangle(base.copy(), p1, p2, (0, 255, 0), thickness)
        assert np.array_equal(out, ref), (p1, p2, thickness)


def test_demo_render_matches_the_jax_demo():
    """``cli/demo.render`` draws what ``tools/demo.py`` draws (the 2D boxes
    with ``cv2.rectangle``, the wireframes through the JAX geometry and
    ``draw_3d_box``), less the text, pixel for pixel."""
    rng = np.random.default_rng(9)
    hw = (288, 1280)
    P2 = testing.KITTI_CALIB['P2'].copy()
    P2[:2] *= 1280 / 1242
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    image = rng.standard_normal((*hw, 3)).astype(np.float32)
    n = 12
    x1 = rng.uniform(-50, 1200, n)
    y1 = rng.uniform(-20, 250, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(5, 300, n), y1 + rng.uniform(5, 150, n),
                      rng.uniform(0, 1280, n), rng.uniform(100, 250, n), rng.uniform(4, 60, n),
                      rng.uniform(1.4, 2.0, n), rng.uniform(1.4, 1.8, n),
                      rng.uniform(3.2, 4.6, n), rng.uniform(-np.pi, np.pi, n)], 1)
    scores = rng.uniform(0.3, 1.0, n)
    for bbox in (boxes.astype(np.float32), boxes[:, :4].astype(np.float32)):
        ref = np.clip((image * std + mean) * 255, 0, 255).astype(np.uint8).copy()
        for b in bbox:
            cv2.rectangle(ref, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])), (0, 255, 0), 2)
            if bbox.shape[1] > 4:
                state = jgeometry.back_projection(b[None, 4:11], P2)[0]
                box7 = np.asarray(state, np.float32)[None]
                _, homo, _ = jgeometry.project_bbox3d(box7, P2.astype(np.float32))
                jax_draw_3d_box(ref, np.asarray(homo)[0].T)
        out = demo.render(image, P2, scores, bbox, mean, std)
        assert np.array_equal(out, ref)


# ------------------------------------------------------------------ refusals


@pytest.mark.parametrize('cli', ['disparity_compute', 'demo'])
def test_new_clis_raise_without_cuda(monkeypatch, tmp_path, cli):
    """The StereoBM precompute and the demo run on the card unless told
    otherwise: without one they raise, they do not fall back."""
    import importlib
    main = importlib.import_module(f'visualdet3d_tpu_torch.cli.{cli}').main
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('VD3D_WORKDIR', str(tmp_path / 'workdirs'))
    config = os.path.join(ROOT, 'configs', 'stereo3d.py')
    if cli == 'disparity_compute':
        split = tmp_path / 'train.txt'
        split.write_text('000000\n')
        cfg_file = tmp_path / 'cfg.py'
        cfg_file.write_text('from visualdet3d_tpu.config import cfg_from_file\n'
                            f'cfg = cfg_from_file({config!r})\n'
                            f'cfg.data.train_split_file = {str(split)!r}\n'
                            f'cfg.path.preprocessed_path = {str(tmp_path / "pre")!r}\n')
        argv = ['--config', str(cfg_file), '--use_stereo_bm']
    else:
        argv = ['--config', config, '--checkpoint_path', str(tmp_path)]
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        main(argv)
