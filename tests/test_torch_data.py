"""The port's data layer against the JAX package's (and against PIL and
OpenCV, which the JAX package reads and writes images with), on the CPU:

* ``data/image_io.py``: PNGs of every filter type, PIL's and OpenCV's own
  output, and hand-filtered files, read bit for bit at 8-bit RGB, gray and
  RGBA and 16-bit gray; the C unfilter against the plain numpy one; the
  writer read back by PIL and OpenCV; what the reader refuses;
* ``data/cv_ops.py`` against ``cv2.resize``, ``cv2.warpAffine`` and
  ``cv2.cvtColor`` on float32 uniform noise in [0, 255] at 375x1242;
* each augmentation, and ``Compose`` of every config's train and test
  lists, under one ``np.random.seed`` (the same draws, the same geometry);
* the datasets' ``__getitem__`` and ``collate_fn`` (the mono right-image
  doubling, the KM3D and MonoFlex targets, the stereo disparity unmirrored
  and mirrored), the samplers' streams and the threaded loader;
* the imdb records, the anchor priors and the disparity PNGs of the
  precompute CLIs against ``read_one_split`` and
  ``compute_disparity_for_split``.

The image gates come from OpenCV 5.0 against exact formulas on float32
noise in [0, 255] at 375x1242 (the worst case): ``cv2.resize`` bilinear
differs from ``F.interpolate(align_corners=False)`` by 0.0185 at most,
``cv2.warpAffine`` from exact-coordinate bilinear sampling by 0.0281. The
gate is 0.05 on [0, 255] images (``PIXEL_GATE``), scaled by the largest
gain a pipeline applies after the operation that differs (contrast up to
1.5; HSV's hue in degrees, 360/255) and divided by 255 x std after
``Normalize``. Geometry (P2, P3, labels, targets) is compared exactly.
"""
import copy
import glob
import io
import itertools
import os
import pickle
import struct
import threading
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import visualdet3d_tpu.data  # noqa: F401  (registers the JAX datasets)
from visualdet3d_tpu.cli import disparity_compute as jax_disparity
from visualdet3d_tpu.cli import imdb_precompute_3d as jax_precompute
from visualdet3d_tpu.data import augmentations as jaug
from visualdet3d_tpu.data import samplers as jsamplers
from visualdet3d_tpu.data.kitti import kittidata as jkitti
from visualdet3d_tpu.data.kitti import utils as jutils
from visualdet3d_tpu.registry import DATASET_DICT as JAX_DATASETS

import visualdet3d_tpu_torch.data  # noqa: F401  (registers the port's datasets)
from visualdet3d_tpu_torch import testing
from visualdet3d_tpu_torch.cli import disparity_compute as port_disparity
from visualdet3d_tpu_torch.cli import imdb_precompute_3d as port_precompute
from visualdet3d_tpu_torch.config import EasyDict as edict
from visualdet3d_tpu_torch.config import cfg_from_file
from visualdet3d_tpu_torch.data import augmentations as paug
from visualdet3d_tpu_torch.data import cv_ops, image_io
from visualdet3d_tpu_torch.data import loader as ploader
from visualdet3d_tpu_torch.data import samplers as psamplers
from visualdet3d_tpu_torch.data.kitti import kittidata as pkitti
from visualdet3d_tpu_torch.data.kitti import utils as putils
from visualdet3d_tpu_torch.registry import DATASET_DICT as PORT_DATASETS

from kitti_fixture import build_mini_kitti, write_split_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, 'configs', '*.py')))
PIXEL_GATE = 0.05       # on [0, 255] images, see the module docstring
CONTRAST_GAIN = 1.5     # PhotometricDistort's largest contrast factor
HUE_GAIN = 360.0 / 255  # an HSV image's hue runs to 360
FULL_FRAMES = 8


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (the tier-1 run
    puts six workers on one machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    """The configs make their directories under ``VD3D_WORKDIR``."""
    with pytest.MonkeyPatch.context() as mp:
        path = tmp_path_factory.mktemp('workdirs')
        mp.setenv('VD3D_WORKDIR', str(path))
        yield path


@pytest.fixture(scope='module')
def configs(workdir):
    return {name: cfg_from_file(os.path.join(ROOT, 'configs', name)) for name in CONFIGS}


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """The JAX tests' mini tree (PIL-written PNGs, 370x1224, 4 frames)."""
    return build_mini_kitti(str(tmp_path_factory.mktemp('mini')))


@pytest.fixture(scope='module')
def full(tmp_path_factory, configs):
    """A full-size synthetic tree (the port's writer, all five filters),
    precomputed by both packages for the stereo config (Car, Pedestrian;
    CropTop 100, Resize 288x1280): imdb, priors and disparity maps."""
    root = testing.write_synthetic_kitti(str(tmp_path_factory.mktemp('full')), FULL_FRAMES,
                                         seed=3)
    train, val = write_split_files(root, str(tmp_path_factory.mktemp('split')),
                                   range(FULL_FRAMES), range(FULL_FRAMES - 2, FULL_FRAMES))
    out = {}
    for name, precompute, disparity in (('jax', jax_precompute, jax_disparity),
                                        ('port', port_precompute, port_disparity)):
        cfg = copy.deepcopy(configs['stereo3d.py'])
        cfg.path.data_path = root
        cfg.path.preprocessed_path = str(tmp_path_factory.mktemp(f'pre_{name}'))
        cfg.detector.head.preprocessed_path = cfg.path.preprocessed_path
        cfg.data.train_split_file, cfg.data.val_split_file = train, val
        names = precompute.process_train_val_file(cfg)
        precompute.read_one_split(cfg, names[0], root, {'calib': True, 'image': True,
                                                        'label': True, 'velodyne': False},
                                  'training')
        precompute.read_one_split(cfg, names[1], root, {'calib': True, 'image': False,
                                                        'label': True, 'velodyne': False},
                                  'validation')
        disparity.compute_disparity_for_split(
            cfg, names[0], root, {'calib': True, 'image': True, 'image_3': True,
                                  'label': False, 'velodyne': True}, 'training')
        out[name] = cfg
    return out


# ---------------------------------------------------------------- PNG reader


def _noise(rng, shape, dtype=np.uint8):
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype)


IMAGE_KINDS = {
    'rgb8': lambda rng: _noise(rng, (37, 53, 3)),
    'gray16': lambda rng: _noise(rng, (29, 41), np.uint16),
}


@pytest.mark.parametrize('kind', sorted(IMAGE_KINDS))
@pytest.mark.parametrize('ftype', image_io.FILTER_TYPES)
def test_png_round_trip_each_filter(kind, ftype):
    """The writer's rows of one filter type read back bit for bit by the
    port (C and plain unfilter) and by PIL (RGB) or OpenCV (16-bit)."""
    image = IMAGE_KINDS[kind](np.random.default_rng(ftype))
    data = image_io.encode_png(image, (ftype,))
    np.testing.assert_array_equal(image_io.decode_png(data), image)
    np.testing.assert_array_equal(image_io.decode_png(data, plain=True), image)
    if kind == 'rgb8':
        np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(data))), image)
    else:
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), -1), image)


def _hand_filtered_png(image, ftype, depth, colour, bpp):
    """A PNG whose rows are filtered by a scalar transcription of the PNG
    specification (section 9.2), independent of ``image_io._filter_rows``."""
    h = image.shape[0]
    rows = (image.astype('>u2').view(np.uint8) if depth == 16 else image).reshape(h, -1)
    out = bytearray()
    for r in range(h):
        out.append(ftype)
        for i in range(rows.shape[1]):
            a = int(rows[r, i - bpp]) if i >= bpp else 0
            b = int(rows[r - 1, i]) if r > 0 else 0
            c = int(rows[r - 1, i - bpp]) if r > 0 and i >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (
                b if abs(p - b) <= abs(p - c) else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ftype]
            out.append((int(rows[r, i]) - pred) % 256)

    def chunk(t, body):
        return struct.pack('>I', len(body)) + t + body + struct.pack('>I', zlib.crc32(t + body))
    header = struct.pack('>IIBBBBB', image.shape[1], h, depth, colour, 0, 0, 0)
    return (image_io.PNG_SIGNATURE + chunk(b'IHDR', header)
            + chunk(b'IDAT', zlib.compress(bytes(out))) + chunk(b'IEND', b''))


HAND_KINDS = {  # (shape, dtype, depth, colour type, bytes a pixel)
    'rgb8': ((6, 9, 3), np.uint8, 8, 2, 3),
    'gray8': ((7, 11), np.uint8, 8, 0, 1),
    'rgba8': ((5, 8, 4), np.uint8, 8, 6, 4),
    'gray16': ((6, 10), np.uint16, 16, 0, 2),
}


@pytest.mark.parametrize('kind', sorted(HAND_KINDS))
@pytest.mark.parametrize('ftype', image_io.FILTER_TYPES)
def test_png_reads_hand_filtered_files(kind, ftype):
    shape, dtype, depth, colour, bpp = HAND_KINDS[kind]
    image = _noise(np.random.default_rng(10 + ftype), shape, dtype)
    data = _hand_filtered_png(image, ftype, depth, colour, bpp)
    np.testing.assert_array_equal(image_io.decode_png(data), image)
    np.testing.assert_array_equal(image_io.decode_png(data, plain=True), image)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), -1)  # BGR(A) order
    if ref.ndim == 3:
        ref = ref[:, :, [2, 1, 0, 3][:ref.shape[2]]]
    np.testing.assert_array_equal(image_io.decode_png(data), ref)


def _smooth(shape):
    """A smooth image: PIL's and OpenCV's encoders pick varied filters."""
    y, x = np.mgrid[:shape[0], :shape[1]]
    base = (3 * x + 2 * y + (x * y) // 7) % 256
    if len(shape) == 2:
        return base.astype(np.uint8)
    return np.stack([(base * (c + 1)) % 256 for c in range(shape[2])], -1).astype(np.uint8)


LIBRARY_IMAGES = {
    'pil_rgb_noise': lambda: ('pil', _noise(np.random.default_rng(0), (40, 60, 3))),
    'pil_rgb_smooth': lambda: ('pil', _smooth((64, 90, 3))),
    'pil_gray_smooth': lambda: ('pil', _smooth((50, 70))),
    'pil_rgba_smooth': lambda: ('pil', _smooth((30, 44, 4))),
    'cv2_rgb_smooth': lambda: ('cv2', _smooth((64, 90, 3))),
    'cv2_gray16': lambda: ('cv2', (_smooth((48, 66)).astype(np.uint16) * 257 + 3)),
}


@pytest.mark.parametrize('name', sorted(LIBRARY_IMAGES))
def test_png_reads_pil_and_opencv_output(name):
    lib, image = LIBRARY_IMAGES[name]()
    if lib == 'pil':
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, 'PNG', optimize=True)
        data = buf.getvalue()
    else:
        bgr = image[:, :, ::-1] if image.ndim == 3 else image
        data = cv2.imencode('.png', bgr)[1].tobytes()
    np.testing.assert_array_equal(image_io.decode_png(data), image)


@pytest.mark.parametrize('bpp', [1, 2, 3, 4, 6])
def test_c_unfilter_matches_plain(bpp):
    """Random filtered bytes with a random filter type a row."""
    rng = np.random.default_rng(bpp)
    h, rowbytes = 23, bpp * 19
    raw = _noise(rng, (h, rowbytes + 1))
    raw[:, 0] = rng.integers(0, 5, h)
    np.testing.assert_array_equal(image_io.unfilter(raw, h, rowbytes, bpp),
                                  image_io.unfilter_plain(raw, h, rowbytes, bpp))


def _patched_header(data, **fields):
    """``data`` with IHDR fields replaced (and its CRC fixed)."""
    keys = ('width', 'height', 'depth', 'colour', 'compression', 'filter', 'interlace')
    values = dict(zip(keys, struct.unpack('>IIBBBBB', data[16:29])), **fields)
    body = struct.pack('>IIBBBBB', *(values[k] for k in keys))
    return data[:16] + body + struct.pack('>I', zlib.crc32(b'IHDR' + body)) + data[33:]


REFUSED = {
    'interlaced': (lambda d: _patched_header(d, interlace=1), 'interlace'),
    'rgb16': (lambda d: _patched_header(d, depth=16), 'bit depth 16, colour type 2'),
    'palette': (lambda d: _patched_header(d, colour=3), 'colour type 3'),
    'bad_crc': (lambda d: d[:30] + bytes([d[30] ^ 1]) + d[31:], 'CRC'),
    'not_png': (lambda d: b'GIF89a' + d[6:], 'not a PNG'),
}


@pytest.mark.parametrize('case', sorted(REFUSED))
def test_png_reader_refuses(case):
    data = image_io.encode_png(_noise(np.random.default_rng(1), (8, 9, 3)))
    patch, message = REFUSED[case]
    with pytest.raises(ValueError, match=message):
        image_io.decode_png(patch(data))


def test_png_reader_refuses_an_unknown_filter_type():
    h, rowbytes = 4, 6
    raw = np.zeros((h, rowbytes + 1), np.uint8)
    raw[2, 0] = 5
    with pytest.raises(ValueError, match='row 2: unknown filter type 5'):
        image_io.unfilter(raw, h, rowbytes, 3)


def test_read_image_matches_pil_convert(tmp_path, mini):
    """``read_image`` is ``kittidata.read_image`` (PIL's convert('RGB')) on
    the mini tree, and on gray and RGBA files."""
    for path in sorted(glob.glob(os.path.join(mini, 'image_*', '*.png')))[:2]:
        np.testing.assert_array_equal(pkitti.read_image(path), jkitti.read_image(path))
    for mode, image in (('L', _smooth((20, 30))), ('RGBA', _smooth((20, 30, 4)))):
        path = str(tmp_path / f'{mode}.png')
        Image.fromarray(image, mode).save(path)
        np.testing.assert_array_equal(pkitti.read_image(path), jkitti.read_image(path))


# ------------------------------------------------------------------ cv_ops


@pytest.fixture(scope='module')
def noise_image():
    return np.random.default_rng(0).uniform(0, 255, (375, 1242, 3)).astype(np.float32)


@pytest.mark.parametrize('size_wh', [(1280, 384), (640, 188), (1280, 288)])
def test_resize_matches_cv2(noise_image, size_wh):
    linear = cv_ops.resize(noise_image, size_wh)
    assert linear.shape == (size_wh[1], size_wh[0], 3) and linear.dtype == np.float32
    assert np.abs(linear - cv2.resize(noise_image, size_wh)).max() <= PIXEL_GATE
    np.testing.assert_array_equal(
        cv_ops.resize(noise_image[:, :, 0], size_wh, cv_ops.INTER_NEAREST),
        cv2.resize(noise_image[:, :, 0], size_wh, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize('scale', [0.6, 1.0, 1.4])
def test_warp_affine_matches_cv2(noise_image, scale):
    """RandomWarpAffine's matrices (scale and shift, parts of the output
    outside the image: the zero border)."""
    final = 1280 / (max(noise_image.shape) * scale)
    matrix = np.array([[final, 0, 640 - 700 * final], [0, final, 192 - 180 * final]],
                      np.float32)
    out = cv_ops.warp_affine(noise_image, matrix, (1280, 384))
    assert np.abs(out - cv2.warpAffine(noise_image, matrix, (1280, 384),
                                       flags=cv2.INTER_LINEAR)).max() <= PIXEL_GATE
    gray = noise_image[:, :, 1]
    assert np.abs(cv_ops.warp_affine(gray, matrix, (1280, 384)) - cv2.warpAffine(
        gray, matrix, (1280, 384), flags=cv2.INTER_LINEAR)).max() <= PIXEL_GATE


def test_hsv_conversions_match_cv2(noise_image):
    image = noise_image.copy()
    image[:8, :8] = 77.0  # gray pixels: S = 0, H = 0
    hsv = cv_ops.rgb_to_hsv(image)
    ref = cv2.cvtColor(image, cv2.COLOR_RGB2HSV)
    assert np.abs(hsv - ref).max() <= PIXEL_GATE * HUE_GAIN
    assert hsv[..., 0].min() >= 0 and hsv[..., 0].max() < 360
    ref[..., 1] *= 1.4  # saturated past 1, hue shifted and wrapped, as the distortions leave it
    ref[..., 0] += 17.0
    ref[..., 0][ref[..., 0] > 360.0] -= 360.0
    assert np.abs(cv_ops.hsv_to_rgb(ref) - cv2.cvtColor(ref, cv2.COLOR_HSV2RGB)).max() \
        <= PIXEL_GATE


# ----------------------------------------------------------- augmentations


def _labels(module, mini, frame=2):
    return module.KittiLabel(os.path.join(mini, 'label_2', '%06d.txt' % frame)
                             ).read_label_file().data


def _sample(module, mini, uint8=False):
    """A stereo sample from the mini tree: both eyes, P2/P3, labels, a
    depth map and a lidar scan."""
    from kitti_fixture import P2, P3
    left = jkitti.read_image(os.path.join(mini, 'image_2', '000002.png'))
    right = left[:, ::-1].copy()
    rng = np.random.default_rng(4)
    if not uint8:
        left, right = left.astype(np.float32), right.astype(np.float32)
    return dict(left_image=left, right_image=right, p2=P2.copy(), p3=P3.copy(),
                labels=_labels(module, mini),
                image_gt=rng.uniform(1, 80, left.shape[:2]).astype(np.float32),
                lidar=rng.uniform(-20, 20, (64, 4)).astype(np.float32))


def _run(module, transforms_cfg, sample, seed):
    np.random.seed(seed)
    return module.Compose(transforms_cfg, is_return_all=True)(**sample)


def _assert_same(jax_out, port_out, gate):
    """Images within ``gate``, the depth map (neither distorted nor
    normalised: values up to 80) within ``PIXEL_GATE``, everything else
    exact."""
    names = ('left_image', 'right_image', 'p2', 'p3', 'labels', 'image_gt', 'lidar')
    for name, a, b in zip(names, jax_out, port_out):
        if name == 'labels':
            assert len(a) == len(b)
            for oa, ob in zip(a, b):
                assert vars(oa) == vars(ob)
        elif name in ('left_image', 'right_image', 'image_gt'):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            limit = PIXEL_GATE if name == 'image_gt' and gate > 0 else gate
            assert np.abs(a.astype(np.float64) - b).max() <= limit, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


NORM = dict(mean=np.array([0.485, 0.456, 0.406]), stds=np.array([0.229, 0.224, 0.225]))
NORM_GAIN = 1 / (255 * NORM['stds'].min())
TRANSFORMS = {  # name: (config entries, uint8 input, image gate)
    'ConvertToFloat': ([edict(type_name='ConvertToFloat')], True, 0.0),
    'Normalize': ([edict(type_name='Normalize', keywords=NORM)], False, 0.0),
    'Resize': ([edict(type_name='Resize', keywords=dict(size=(288, 1280)))], False,
               PIXEL_GATE),
    'Resize_no_aspect': ([edict(type_name='Resize', keywords=dict(
        size=(384, 1280), preserve_aspect_ratio=False))], False, PIXEL_GATE),
    'ResizeToFx': ([edict(type_name='ResizeToFx', keywords=dict(Fx=600.0))], False,
                   PIXEL_GATE),
    'CropTop': ([edict(type_name='CropTop', keywords=dict(crop_top_index=100))], False, 0.0),
    'CropTop_height': ([edict(type_name='CropTop', keywords=dict(output_height=300))], False,
                       0.0),
    'CropRight': ([edict(type_name='CropRight', keywords=dict(output_width=1000))], False, 0.0),
    'FilterObject': ([edict(type_name='CropRight', keywords=dict(output_width=600)),
                      edict(type_name='FilterObject')], False, 0.0),
    'RandomCropToWidth': ([edict(type_name='RandomCropToWidth', keywords=dict(width=1000))],
                          False, 0.0),
    'RandomMirror': ([edict(type_name='RandomMirror', keywords=dict(mirror_prob=1.0))], False,
                     0.0),
    'RandomWarpAffine': ([edict(type_name='RandomWarpAffine', keywords=dict(
        output_w=1280, output_h=384))], False, PIXEL_GATE),
    'RandomSaturation': ([edict(type_name='ConvertColor'),
                          edict(type_name='RandomSaturation', keywords=dict(distort_prob=1.0))],
                         False, PIXEL_GATE * HUE_GAIN),
    'RandomHue': ([edict(type_name='ConvertColor'),
                   edict(type_name='RandomHue', keywords=dict(distort_prob=1.0, delta=90.0))],
                  False, PIXEL_GATE * HUE_GAIN),
    'ConvertColor': ([edict(type_name='ConvertColor'),
                      edict(type_name='ConvertColor', keywords=dict(current='HSV',
                                                                    transform='RGB'))],
                     False, PIXEL_GATE),
    'RandomContrast': ([edict(type_name='RandomContrast', keywords=dict(distort_prob=1.0))],
                       False, 0.0),
    'RandomBrightness': ([edict(type_name='RandomBrightness', keywords=dict(distort_prob=1.0))],
                         False, 0.0),
    'RandomEigenvalueNoise': ([edict(type_name='RandomEigenvalueNoise')], False, 0.0),
    'PhotometricDistort': ([edict(type_name='PhotometricDistort',
                                  keywords=dict(distort_prob=1.0))], False,
                           PIXEL_GATE * CONTRAST_GAIN),
    'Shuffle': ([edict(type_name='Shuffle', keywords=dict(aug_list=[
        edict(type_name='RandomBrightness', keywords=dict(distort_prob=1.0)),
        edict(type_name='CropTop', keywords=dict(crop_top_index=50)),
        edict(type_name='RandomMirror', keywords=dict(mirror_prob=0.5)),
        edict(type_name='RandomContrast', keywords=dict(distort_prob=1.0))]))], False, 0.0),
}


def test_every_augmentation_is_registered_and_covered():
    assert set(paug.AUGMENTATION_DICT.keys()) == set(jaug.AUGMENTATION_DICT.keys())
    covered = {c.type_name for cfgs, _, _ in TRANSFORMS.values() for c in cfgs}
    assert covered | {'Compose'} == set(paug.AUGMENTATION_DICT.keys())


@pytest.mark.parametrize('name', sorted(TRANSFORMS))
@pytest.mark.parametrize('seed', [0, 5])
def test_augmentation_matches_jax(mini, name, seed):
    cfgs, uint8, gate = TRANSFORMS[name]
    jax_out = _run(jaug, cfgs, _sample(jkitti, mini, uint8), seed)
    jax_state = np.random.get_state()[1].copy()
    port_out = _run(paug, cfgs, _sample(pkitti, mini, uint8), seed)
    np.testing.assert_array_equal(np.random.get_state()[1], jax_state)  # the same draws
    _assert_same(jax_out, port_out, gate)


def _pipeline_gate(aug_list):
    """The image gate of a config's list: the contrast gain when it
    distorts, divided by 255 x std when it normalises."""
    names = [a.type_name for a in aug_list]
    gate = PIXEL_GATE * (CONTRAST_GAIN if 'PhotometricDistort' in names else 1.0)
    return gate * (NORM_GAIN if 'Normalize' in names else 1.0)


@pytest.mark.parametrize('split', ['train_augmentation', 'test_augmentation'])
@pytest.mark.parametrize('config', CONFIGS)
def test_config_augmentations_match_jax(mini, configs, config, split):
    aug_list = configs[config].data[split]
    for seed in (1, 2):
        jax_out = _run(jaug, aug_list, _sample(jkitti, mini, uint8=True), seed)
        port_out = _run(paug, aug_list, _sample(pkitti, mini, uint8=True), seed)
        _assert_same(jax_out, port_out, _pipeline_gate(aug_list))


# ---------------------------------------------------------------- datasets


def _dataset_cfg(full, config, configs, package):
    """``config``'s data and obj_types over the precomputed tree of
    ``package``."""
    cfg = copy.deepcopy(configs[config])
    cfg.path = full[package].path
    return cfg


def _assert_items_equal(a, b, gate):
    for key in a:
        va, vb = a[key], b[key]
        if key == 'image':
            if isinstance(va, list):
                for x, y in zip(va, vb):
                    assert np.abs(x - y).max() <= gate
            else:
                assert np.abs(va - vb).max() <= gate
        elif key == 'label' and isinstance(va, dict):
            assert va.keys() == vb.keys()
            for k in va:
                np.testing.assert_array_equal(va[k], vb[k], err_msg=k)
        elif isinstance(va, list) and va and isinstance(va[0], np.ndarray):
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            np.testing.assert_array_equal(va, vb, err_msg=key)


@pytest.mark.parametrize('config', ['yolo3d_gac.py', 'km3d.py', 'monoflex.py'])
def test_mono_datasets_match_jax(full, configs, config):
    """``train_dataset`` of the config: the mono dataset doubles with the
    right images (P3), KM3D's and MonoFlex's carry their targets."""
    datasets = {}
    for package, registry in (('jax', JAX_DATASETS), ('port', PORT_DATASETS)):
        cfg = _dataset_cfg(full, config, configs, package)
        datasets[package] = registry[cfg.data.train_dataset](cfg, 'training')
    use_right = configs[config].data.get('use_right_image', True)
    assert len(datasets['port']) == len(datasets['jax']) == FULL_FRAMES * (2 if use_right else 1)
    gate = _pipeline_gate(configs[config].data.train_augmentation)
    items = {}
    for package in ('jax', 'port'):
        items[package] = []
        for index in (0, 3, len(datasets[package]) - 1):
            np.random.seed(index)
            items[package].append(datasets[package][index])
    for a, b in zip(items['jax'], items['port']):
        _assert_items_equal(a, b, gate)
    collated = {p: type(datasets[p]).collate_fn(items[p], obj_types=configs[config].obj_types,
                                                 max_objects=32) for p in items}
    for key, value in collated['jax'].items():
        if isinstance(value, np.ndarray) and key != 'images':
            np.testing.assert_array_equal(collated['port'][key], value, err_msg=key)
        elif isinstance(value, dict):
            for k in value:
                np.testing.assert_array_equal(collated['port'][key][k], value[k], err_msg=k)
    assert np.abs(collated['port']['images'] - collated['jax']['images']).max() <= gate


@pytest.mark.parametrize('mirror', [0.0, 1.0])
def test_stereo_dataset_matches_jax(full, configs, mirror):
    """Unmirrored: P2's disparity map; mirrored (eyes and P2/P3 swapped):
    P3's, flipped."""
    datasets = {}
    for package, registry in (('jax', JAX_DATASETS), ('port', PORT_DATASETS)):
        cfg = _dataset_cfg(full, 'stereo3d.py', configs, package)
        for aug in cfg.data.train_augmentation:
            if aug.type_name == 'RandomMirror':
                aug.keywords.mirror_prob = mirror
        datasets[package] = registry['KittiStereoDataset'](cfg, 'training')
    gate = _pipeline_gate(configs['stereo3d.py'].data.train_augmentation)
    items = {}
    for package in ('jax', 'port'):
        np.random.seed(7)
        items[package] = [datasets[package][i] for i in (1, 2)]
    for a, b in zip(items['jax'], items['port']):
        _assert_items_equal(a, b, gate)
        assert (abs(b['calib'][0][0, 3]) > abs(b['calib'][1][0, 3])) == (mirror == 1.0)
        assert b['disparity'].shape == (288 // 4, 1280 // 4)
    collated = {p: datasets[p].collate_fn(items[p], obj_types=['Car', 'Pedestrian'])
                for p in items}
    for key in ('P2', 'P3', 'disparity', 'annotations'):
        np.testing.assert_array_equal(collated['port'][key], collated['jax'][key], err_msg=key)


@pytest.mark.parametrize('config', ['stereo3d.py', 'yolo3d_gac.py'])
def test_validation_and_test_datasets_match_jax(full, configs, config):
    """``val_dataset`` (the test augmentation, no doubling) and the
    label-free test datasets over the validation imdb."""
    cfgs = {p: _dataset_cfg(full, config, configs, p) for p in ('jax', 'port')}
    for p in cfgs:  # the test datasets read preprocessed/test/imdb.pkl
        os.makedirs(os.path.join(cfgs[p].path.preprocessed_path, 'test'), exist_ok=True)
        with open(os.path.join(cfgs[p].path.preprocessed_path, 'validation', 'imdb.pkl'),
                  'rb') as f:
            records = pickle.load(f)
        with open(os.path.join(cfgs[p].path.preprocessed_path, 'test', 'imdb.pkl'), 'wb') as f:
            pickle.dump(records, f)
    gate = _pipeline_gate(configs[config].data.test_augmentation)
    for key in ('val_dataset', 'test_dataset'):
        name = configs[config].data[key]
        split = 'validation' if key == 'val_dataset' else 'test'
        jax_ds = JAX_DATASETS[name](cfgs['jax'], split)
        port_ds = PORT_DATASETS[name](cfgs['port'], split)
        assert len(port_ds) == len(jax_ds) == 2
        a, b = jax_ds[1], port_ds[1]
        _assert_items_equal(a, b, gate)
        batch_a = type(jax_ds).collate_fn([a], obj_types=configs[config].obj_types)
        batch_b = type(port_ds).collate_fn([b], obj_types=configs[config].obj_types)
        assert batch_a.keys() == batch_b.keys()


# --------------------------------------------------------- samplers, loader


def _take(iterable, n):
    return list(itertools.islice(iter(iterable), n))


@pytest.mark.parametrize('shuffle,seed,rank,world', [
    (True, None, 0, 1), (True, 7, 1, 3), (False, None, 0, 1), (False, 3, 2, 4)])
def test_training_sampler_stream_matches_jax(shuffle, seed, rank, world):
    n = 13
    streams = []
    for module in (jsamplers, psamplers):
        sampler = module.TrainingSampler(n, shuffle=shuffle, seed=seed, rank=rank,
                                         world_size=world)
        first = _take(sampler, 40)
        again = _take(sampler, 40)
        assert first == again  # each iteration replays the stream from the seed
        streams.append(first)
    assert streams[0] == streams[1]


@pytest.mark.parametrize('size,world', [(10, 1), (10, 3), (7, 4)])
def test_inference_sampler_matches_jax(size, world):
    for rank in range(world):
        a = jsamplers.InferenceSampler(size, rank=rank, world_size=world)
        b = psamplers.InferenceSampler(size, rank=rank, world_size=world)
        assert list(a) == list(b) and len(a) == len(b)


@pytest.mark.parametrize('augmentation,workers', [('test_augmentation', 3),
                                                  ('train_augmentation', 1)])
def test_threaded_loader_equals_synchronous(full, configs, augmentation, workers):
    """With the deterministic test augmentation any number of threads gives
    the synchronous batches; with the random train augmentation one thread
    draws in the synchronous order."""
    cfg = _dataset_cfg(full, 'yolo3d_gac.py', configs, 'port')
    cfg.data.train_augmentation = cfg.data[augmentation]
    dataset = PORT_DATASETS['KittiMonoDataset'](cfg, 'training')

    def collate(items):
        return dataset.collate_fn(items, obj_types=cfg.obj_types)

    batches = {}
    for n in (0, workers):
        np.random.seed(11)
        loader = ploader.DataLoader(dataset, 2, collate, psamplers.TrainingSampler(
            len(dataset), seed=2), num_workers=n)
        batches[n] = _take(loader, 3)
    for a, b in zip(batches[0], batches[workers]):
        np.testing.assert_array_equal(a['images'], b['images'])
        np.testing.assert_array_equal(a['annotations'], b['annotations'])


def test_loader_stops_its_producer_and_raises_worker_errors():
    """An epoch that stops early (an infinite sampler cut by islice) ends
    the producer thread; an error in ``__getitem__`` reaches the consumer."""
    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            if i == 7:
                raise KeyError('item 7')
            return np.full(2, i)

    before = threading.active_count()
    loader = ploader.DataLoader(Items(), 2, np.stack, psamplers.TrainingSampler(
        10, shuffle=False), num_workers=2, prefetch=1)
    it = iter(loader)
    assert next(it).tolist() == [[0, 0], [1, 1]]
    it.close()
    assert threading.active_count() == before
    with pytest.raises(KeyError, match='item 7'):
        _take(loader, 5)
    assert threading.active_count() == before


def test_build_dataloader_matches_jax_batches(full, configs):
    from visualdet3d_tpu.data.loader import build_dataloader as jax_build
    cfg = _dataset_cfg(full, 'yolo3d_gac.py', configs, 'port')
    dataset = PORT_DATASETS['KittiMonoDataset'](cfg, 'validation')
    sizes = []
    for build in (jax_build, ploader.build_dataloader):
        loader = build(dataset, num_workers=0, batch_size=1, collate_fn=len,
                       training=False)
        sizes.append((len(loader), list(loader)))
    assert sizes[0] == sizes[1] == (2, [1, 1])


# ------------------------------------------------------- KITTI I/O, utils


def test_kitti_frame_matches_jax(mini):
    out = {}
    for module in (jkitti, pkitti):
        frame = module.KittiData(mini, '000002', {'calib': True, 'image': True,
                                                  'image_3': True, 'label': True,
                                                  'velodyne': True})
        out[module] = frame.read_data()
    (jc, ji, ji3, jl, jp), (pc, pi, pi3, pl, pp) = out[jkitti], out[pkitti]
    for name in ('P2', 'P3', 'R0_rect', 'Tr_velo_to_cam'):
        np.testing.assert_array_equal(getattr(pc, name), getattr(jc, name))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pi3, ji3)
    np.testing.assert_array_equal(pp, jp)
    assert [vars(o) for o in pl.data] == [vars(o) for o in jl.data]
    assert str(pl) == str(jl)
    pts = pp[:20, :3].astype(np.float64)
    np.testing.assert_array_equal(pc.lidar2leftcam(pts), jc.lidar2leftcam(pts))
    np.testing.assert_array_equal(pc.leftcam2lidar(pts), jc.leftcam2lidar(pts))
    np.testing.assert_array_equal(pc.leftcam2imgplane(pts), jc.leftcam2imgplane(pts))


def test_velodyne_rasters_and_result_files_match_jax(mini, tmp_path):
    calib = pkitti.KittiCalib(os.path.join(mini, 'calib', '000000.txt')).read_calib_file()
    pc = pkitti.read_pc_from_bin(os.path.join(mini, 'velodyne', '000000.bin'))
    args = (pc, 370, 1224, calib.Tr_velo_to_cam, calib.R0_rect, calib.P2)
    np.testing.assert_array_equal(putils.generate_disparity_from_velo(*args, baseline=0.53),
                                  jutils.generate_disparity_from_velo(*args, baseline=0.53))
    np.testing.assert_array_equal(putils.generate_depth_from_velo(*args),
                                  jutils.generate_depth_from_velo(*args))
    rng = np.random.default_rng(0)
    boxes, state = rng.uniform(0, 300, (3, 4)), rng.uniform(1, 9, (3, 7))
    for i, module in enumerate((jutils, putils)):
        d = tmp_path / str(i)
        d.mkdir()
        module.write_result_to_file(str(d), 5, [0.9, 0.3, 0.5], boxes, state,
                                    thetas=np.array([0.1, 0.2, 0.3]),
                                    obj_types=['Car', 'Car', 'Pedestrian'])
    assert (tmp_path / '1' / '000005.txt').read_text() == (tmp_path / '0' / '000005.txt').read_text()


# ---------------------------------------------------------- precompute


@pytest.mark.parametrize('split', ['training', 'validation'])
def test_imdb_records_match_jax(full, split):
    records = {}
    for package in ('jax', 'port'):
        with open(os.path.join(full[package].path.preprocessed_path, split, 'imdb.pkl'),
                  'rb') as f:
            records[package] = pickle.load(f)
    assert len(records['port']) == len(records['jax'])
    for a, b in zip(records['jax'], records['port']):
        for key in ('index', 'image_2_path', 'image_3_path', 'velodyne_path'):
            assert a[key] == b[key]
        for key in a['calib']:
            np.testing.assert_array_equal(a['calib'][key], b['calib'][key])
        assert [vars(o) for o in a['label']] == [vars(o) for o in b['label']]
    kept = sum(len(r['label']) for r in records['port'])
    assert kept > 0


@pytest.mark.parametrize('obj_type', ['Car', 'Pedestrian'])
def test_anchor_priors_match_jax(full, obj_type):
    for stat in ('mean', 'std'):
        arrays = [np.load(os.path.join(full[p].path.preprocessed_path, 'training',
                                       f'anchor_{stat}_{obj_type}.npy')) for p in ('jax', 'port')]
        np.testing.assert_array_equal(arrays[1], arrays[0])
        assert np.isfinite(arrays[1]).all()
    if obj_type == 'Car':  # some bin has ten samples: the comparison is not only the fill
        mean = np.load(os.path.join(full['port'].path.preprocessed_path, 'training',
                                    'anchor_mean_Car.npy'))
        assert (mean[..., 0] > 0).any()


def test_disparity_maps_match_jax(full):
    """The port's PNGs hold JAX's (``cv2.imwrite``) values, each map at the
    augmented input's quarter resolution."""
    names = sorted(os.listdir(os.path.join(full['port'].path.preprocessed_path,
                                           'training', 'disp')))
    assert len(names) == 2 * FULL_FRAMES
    for name in names:
        jax_map = cv2.imread(os.path.join(full['jax'].path.preprocessed_path, 'training',
                                          'disp', name), -1)
        port_path = os.path.join(full['port'].path.preprocessed_path, 'training', 'disp', name)
        port_map = image_io.read_png(port_path)
        assert port_map.dtype == np.uint16 and port_map.shape == (288 // 4, 1280 // 4)
        np.testing.assert_array_equal(port_map, jax_map)
        np.testing.assert_array_equal(cv2.imread(port_path, -1), jax_map)
        assert port_map.max() > 0


def test_stereo_bm_path_raises(full, tmp_path):
    """The ``--use_stereo_bm`` path (its name kept from when the port raised
    there): the port's maps of a 2-frame tree whose right eyes are the left
    ones shifted by a known field (``stereo_shift``: on independent noise
    eyes StereoBM finds almost nothing), its block matcher's plain version
    on the CPU, equal bit for bit to the JAX CLI's (``cv2.StereoBM``,
    ``cv2.imwrite``), and most of each map's blocks matched."""
    root = testing.write_synthetic_kitti(str(tmp_path / 'kitti'), 2, seed=5, stereo_shift=True)
    od = {'calib': True, 'image': True, 'image_3': True, 'label': False, 'velodyne': False}
    dirs = {}
    for name, module in (('jax', jax_disparity), ('port', port_disparity)):
        cfg = copy.deepcopy(full[name])
        cfg.path.preprocessed_path = str(tmp_path / name)
        kwargs = {'device': 'cpu'} if name == 'port' else {}
        module.compute_disparity_for_split(cfg, ['%06d' % i for i in range(2)], root, od,
                                           'training', use_point_cloud=False, **kwargs)
        dirs[name] = os.path.join(cfg.path.preprocessed_path, 'training', 'disp')
    names = sorted(os.listdir(dirs['port']))
    assert names == sorted(os.listdir(dirs['jax'])) == ['P2000000.png', 'P2000001.png',
                                                         'P3000000.png', 'P3000001.png']
    for name in names:
        port_map = image_io.read_png(os.path.join(dirs['port'], name))
        assert port_map.dtype == np.uint16 and port_map.shape == (288 // 4, 1280 // 4)
        np.testing.assert_array_equal(port_map, cv2.imread(os.path.join(dirs['jax'], name), -1))
        assert (port_map > 0).mean() > 0.5  # the valid region touches 76.5% of the blocks
