"""The whole ported slice against the JAX package, on the CPU: YOLOStereo3D
inference at the ``tiny_stereo_cfg`` shape (ResNet-18, 64x160, batch 2).

JAX init, seeded values for the zero-initialised prediction convs (scaled
so that a good share of the anchors scores above ``score_thr``, with
distinct scores), the weight bridge, then raw predictions and the decoded,
NMS-filtered detections of both frameworks. f32 tolerances: rtol = atol =
1e-4 (conv summation order, XLA CPU against oneDNN, grown through the
network). bf16: rtol 3e-2 on the raw predictions, the rounding gap between
two frameworks that round at different places; the NMS sets are not
compared under bf16. The JAX side runs jitted: eager op-by-op dispatch of
the whole network costs about ten times as long on the CPU.
"""
import copy

import numpy as np
import jax
import pytest
import torch

from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
import visualdet3d_tpu.models.detectors.yolostereo3d  # noqa: F401
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.ops import cost_volume as cv
from visualdet3d_tpu_torch.registry import DETECTOR_DICT
import visualdet3d_tpu_torch.models  # noqa: F401

from helpers import write_fake_priors
from test_stereo_system import IMAGE_HW, sample_P, tiny_stereo_cfg

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 2


def _seeded_prediction_convs(jsys, variables, inputs, rng):
    """Unit-normal prediction convs rescaled (an exact affine change of the
    logits) to class logits of mean 0, std 2 and regressions of std 0.5."""
    params = _to_dict(variables['params'])
    head = params['StereoHead_0']
    convs = [head['_ClsBranch_0']['Conv_2'], head['Conv_0']]
    for conv in convs:
        conv['kernel'] = rng.standard_normal(conv['kernel'].shape).astype(np.float32)
        conv['bias'] = np.zeros_like(conv['bias'])
    variables = {'params': params, 'batch_stats': _to_dict(variables['batch_stats'])}
    cls, reg, _ = _jax_raw(jsys)(variables, *inputs)
    for conv, preds, mean, std in ((convs[0], cls, 0.0, 2.0), (convs[1], reg, 0.0, 0.5)):
        preds = np.asarray(preds)
        a = std / preds.std()
        conv['kernel'] = (conv['kernel'] * a).astype(np.float32)
        conv['bias'] = np.full_like(conv['bias'], mean - a * preds.mean())
    return variables


def _jax_raw(jsys):
    return jax.jit(lambda v, l, r, p: jsys.net.apply(v, l, r, p, train=False))


def _to_dict(tree):
    if hasattr(tree, 'items'):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    pre = str(tmp_path_factory.mktemp('pre'))
    write_fake_priors(pre, ['Car', 'Pedestrian'])
    cfg = tiny_stereo_cfg(pre)
    jsys = JAX_DETECTORS[cfg.name](cfg)
    rng = np.random.default_rng(0)
    left = rng.standard_normal((BATCH, *IMAGE_HW, 3)).astype(np.float32)
    right = rng.standard_normal((BATCH, *IMAGE_HW, 3)).astype(np.float32)
    P2 = sample_P(BATCH)
    variables = jax.jit(lambda key: jsys.init(key, IMAGE_HW, batch_size=1))(
        jax.random.PRNGKey(0))
    variables = _seeded_prediction_convs(jsys, variables, (left, right, P2), rng)

    tsys = DETECTOR_DICT['Stereo3D'](EasyDict(copy.deepcopy(cfg)), device='cpu')
    skipped = tsys.load_flax_variables(variables)
    return jsys, variables, tsys, skipped, (left, right, P2)


def test_bridge_skips_only_the_train_only_disparity_head(pair):
    _, variables, _, skipped, _ = pair
    prefix = 'StereoMerging_0/CostVolumePyramid_0/'
    expected = sorted(
        [f'params/{prefix}{m}/{leaf}' for m in ('Conv_0', 'Conv_1', 'Conv_2')
         for leaf in ('kernel', 'bias')]
        + [f'params/{prefix}{m}/{leaf}' for m in ('BatchNorm_0', 'BatchNorm_1')
           for leaf in ('scale', 'bias')]
        + [f'batch_stats/{prefix}{m}/{leaf}' for m in ('BatchNorm_0', 'BatchNorm_1')
           for leaf in ('mean', 'var')])
    assert sorted(skipped) == expected


def test_raw_predictions_match_jax_f32(pair):
    jsys, variables, tsys, _, (left, right, P2) = pair
    ref_cls, ref_reg, _ = _jax_raw(jsys)(variables, left, right, P2)
    cls, reg = tsys.predict_raw(torch.from_numpy(left), torch.from_numpy(right))
    assert cls.shape == ref_cls.shape and reg.shape == ref_reg.shape
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref_cls), **TOL)
    np.testing.assert_allclose(reg.numpy(), np.asarray(ref_reg), **TOL)


def test_predict_matches_jax_f32(pair):
    jsys, variables, tsys, _, (left, right, P2) = pair
    ref = jax.jit(lambda v, l, r, p: jsys.predict(v, l, r, p, max_detections=8))(
        variables, left, right, P2)
    cv.reset_launch_counts()
    out = tsys.predict(torch.from_numpy(left), torch.from_numpy(right),
                       torch.from_numpy(P2), max_detections=8)
    assert cv.LAUNCHES['correlation_volume_interleaved'] == 0  # CPU: the plain path
    valid = np.asarray(ref['valid'])
    assert valid.sum() >= 2 * BATCH  # the seeded convs give NMS something to do
    np.testing.assert_array_equal(out['valid'].numpy(), valid)
    np.testing.assert_array_equal(out['labels'].numpy()[valid], np.asarray(ref['labels'])[valid])
    np.testing.assert_allclose(out['bboxes'].numpy()[valid], np.asarray(ref['bboxes'])[valid],
                               **TOL)
    np.testing.assert_allclose(out['scores'].numpy()[valid], np.asarray(ref['scores'])[valid],
                               atol=1e-5)
    assert np.all(out['scores'].numpy()[~valid] == 0)


def test_raw_predictions_match_jax_bf16(pair):
    jsys, variables, tsys, _, (left, right, P2) = pair
    jsys.cfg.inference_dtype = 'bfloat16'
    tsys.cfg.inference_dtype = 'bfloat16'
    try:
        bf16_vars, (jl, jr), _ = jsys._inference_cast(variables, [left, right])
        ref_cls, ref_reg, _ = _jax_raw(jsys)(bf16_vars, jl, jr, P2)
        cls, reg = tsys.predict_raw(torch.from_numpy(left), torch.from_numpy(right))
        out = tsys.predict(torch.from_numpy(left), torch.from_numpy(right),
                           torch.from_numpy(P2), max_detections=8)
    finally:
        jsys.cfg.inference_dtype = 'float32'
        tsys.cfg.inference_dtype = 'float32'
    assert cls.dtype == torch.bfloat16 and reg.dtype == torch.bfloat16
    for o, r in ((cls, ref_cls), (reg, ref_reg)):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(o.float().numpy(), r, rtol=3e-2,
                                   atol=3e-2 * np.abs(r).max())
    assert out['scores'].dtype == torch.float32
    assert np.all(np.isfinite(out['bboxes'].numpy()))
