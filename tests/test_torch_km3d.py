"""The ported KM3D inference slice against the JAX package, on the CPU.

Module by module (the bilinear upsample, the DLA trunk at depth 34 and at a
bottleneck depth, the DCN neck, the decode helpers and NMS), then the whole
``KM3D`` at 64x256, batch 2, ``head_features=16``, top-K 20. At 64x256 every
DCN's pixel count (16, 64, 256, 1024) is a multiple of 8, so all 16 take
the Pallas kernels K3 (bf16) and K5 (f32) on the JAX side (asserted), run
in interpret mode.

Weights: JAX init, through the bridge; then the zero-initialised offset
convs and the head's output convs are seeded on the port's side
(``testing.seed_offset_convs`` at a 1 px offset std,
``testing.calibrate_head_convs``) and copied back into the flax tree, so
both frameworks run the same weights and the DCNs interpolate.

Tolerances. f32: raw outputs rtol 1e-4 and atol 1e-4 of each map's std
(conv summation order, XLA CPU against oneDNN, grown through the network;
the seeded head scales some maps to a std of 4); after the decode, the same
valid set and labels, scores within 1e-5, 2D boxes, dimensions and alpha
rtol = atol = 1e-3, the 3D centre (cx3d, cy3d, z) rtol 1e-2 (it comes from
a 3x3 least-squares solve and a division by depth, which amplify the raw
outputs' differences). bf16: each raw map within a
norm-wise relative error of 3e-2 (||out - ref|| / ||ref||), the rounding gap
of two frameworks that round at different places. It is norm-wise because
a one-ulp difference in a bf16 offset of a few pixels moves a sample by up
to 1/64 px, and on these white-noise features that moves single outputs by
a few percent while each map as a whole agrees to 1-2%. The JAX side runs
jitted.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualdet3d_tpu.models.backbones import dla as jax_dla
from visualdet3d_tpu.models.backbones import dla_utils as jax_dla_utils
from visualdet3d_tpu.models.heads import rtm3d_utils as jax_rtm
from visualdet3d_tpu.ops.nms import nms as jax_nms
from visualdet3d_tpu.ops.deform_conv import _packed_f32_ok, _packed_ok
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
import visualdet3d_tpu.models.detectors.km3d  # noqa: F401
from visualdet3d_tpu_torch import convert, testing
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.models.backbones import dla, dla_utils
from visualdet3d_tpu_torch.models.blocks import ModulatedDeformConv, channels_last_
from visualdet3d_tpu_torch.models.heads import km3d_head, rtm3d_utils as rtm
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.ops import nms as nms_lib
from visualdet3d_tpu_torch.registry import DETECTOR_DICT
import visualdet3d_tpu_torch.models  # noqa: F401

@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs: the tier-1 run
    puts six workers on one machine, where torch's spinning thread pool
    costs several times its work (the tensors here are small)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-4, atol=1e-4)
BOX_TOL = dict(rtol=1e-3, atol=1e-3)
CENTRE_TOL = dict(rtol=1e-2, atol=1e-3)
CENTRE = slice(4, 7)  # cx3d, cy3d, z of the [.., 11] boxes
IMAGE_HW = (64, 256)
BATCH = 2
MAX_DET = 16
P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
               [0.0, 721.5377, 172.854, 0.2163791],
               [0.0, 0.0, 1.0, 0.002745884]], np.float32)


def _to_dict(tree):
    if hasattr(tree, 'items'):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _copy_conv_to_flax(params, name: str, conv: torch.nn.Conv2d) -> None:
    """Write a torch conv (module path ``name``) into the flax params tree."""
    node = params
    for part in name.split('.'):
        node = node[part]
    node['kernel'] = conv.weight.detach().permute(2, 3, 1, 0).contiguous().numpy()
    node['bias'] = conv.bias.detach().numpy().copy()


def _seed_flax_offset_convs(params, rng, std):
    """Seeded offset convs for a flax tree (every ModulatedDeformConv_0/Conv_0)."""
    for key, value in params.items():
        if key == 'ModulatedDeformConv_0':
            k = value['Conv_0']['kernel']
            value['Conv_0']['kernel'] = (rng.standard_normal(k.shape) * std).astype(np.float32)
        elif isinstance(value, dict):
            _seed_flax_offset_convs(value, rng, std)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize('factor', [2, 4])
def test_bilinear_up_matches_jax_resize(factor):
    x = np.random.default_rng(factor).standard_normal((2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_dla_utils._bilinear_up(jnp.asarray(x), factor))
    out = _nhwc(dla_utils._bilinear_up(_nchw(x), factor))
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize('depth', [34, 46])
def test_dla_trunk_matches_jax(depth):
    x = np.random.default_rng(depth).standard_normal((2, 32, 64, 3)).astype(np.float32)
    jmod = jax_dla.dlanet(depth)
    variables = _to_dict(jax.jit(lambda k, im: jmod.init(k, im, train=False))(
        jax.random.PRNGKey(depth), jnp.asarray(x)))
    refs = jax.jit(lambda v, im: jmod.apply(v, im, train=False))(variables, jnp.asarray(x))
    tmod = channels_last_(dla.dlanet(depth)).eval()
    assert convert.load_flax_variables(tmod, variables) == []
    with torch.no_grad():
        outs = tmod(_nchw(x))
    assert len(outs) == len(refs) == 6
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **TOL)


def test_dla_seg_upsample_matches_jax():
    """The DCN neck (DLAUp + IDAUp, 16 DCNs) with seeded offset convs."""
    rng = np.random.default_rng(7)
    channels = (16, 32, 64, 128, 256, 512)
    feats = [rng.standard_normal((2, 32 >> i, 64 >> i, c)).astype(np.float32)
             for i, c in enumerate(channels)]
    jmod = jax_dla_utils.DLASegUpsample(input_channels=channels, down_ratio=4, last_level=5,
                                        out_channel=64)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = _to_dict(jax.jit(lambda k, fs: jmod.init(k, fs, train=False))(
        jax.random.PRNGKey(1), jfeats))
    _seed_flax_offset_convs(variables['params'], rng, 0.05)
    ref = np.asarray(jax.jit(lambda v, fs: jmod.apply(v, fs, train=False))(variables, jfeats))
    tmod = channels_last_(dla_utils.DLASegUpsample(channels, 4, 5, 64)).eval()
    assert convert.load_flax_variables(tmod, variables) == []
    assert sum(isinstance(m, ModulatedDeformConv) for m in tmod.modules()) == 16
    with torch.no_grad():
        out = _nhwc(tmod([_nchw(f) for f in feats]))
    assert out.shape == ref.shape == (2, 8, 16, 64)
    np.testing.assert_allclose(out, ref, **TOL)


def test_topk_with_ties_matches_jax():
    """Exact zeros (what heatmap_nms leaves) and repeated peaks: the lower
    flat index comes first, as in ``jax.lax.top_k``."""
    rng = np.random.default_rng(3)
    heat = np.zeros((2, 6, 7, 2), np.float32)
    heat[0, 1, 2, 0] = heat[0, 4, 1, 0] = heat[0, 2, 5, 1] = 0.7
    heat[1, 3, 3, 1] = 0.9
    heat[1, 0, 6, 0] = heat[1, 5, 0, 1] = 0.4
    heat[:, 2, 2, :] = rng.uniform(0.1, 0.3, (2, 2))
    for k in (5, 12):
        ref = jax_rtm.topk(jnp.asarray(heat), k=k)
        out = rtm.topk(torch.from_numpy(heat), k=k)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        ref = jax_rtm.topk_channel(jnp.asarray(heat), k=k)
        out = rtm.topk_channel(torch.from_numpy(heat), k=k)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_heatmap_nms_matches_jax():
    heat = np.random.default_rng(4).uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    heat[0, 4, 4:6, 0] = 0.95  # a plateau: both equal maxima survive
    ref = np.asarray(jax_rtm.heatmap_nms(jnp.asarray(heat)))
    np.testing.assert_array_equal(rtm.heatmap_nms(torch.from_numpy(heat)).numpy(), ref)


def test_gen_position_matches_jax():
    rng = np.random.default_rng(5)
    b, k = 2, 7
    kps = (rng.uniform(100, 1100, (b, k, 1, 1)) + rng.normal(0, 30, (b, k, 18, 1)))
    kps[..., 1::2, 0] = rng.uniform(150, 250, (b, k, 9))
    kps = kps[..., 0].astype(np.float32)
    dim = rng.uniform(1.4, 4.0, (b, k, 3)).astype(np.float32)
    rot = rng.normal(0, 1, (b, k, 8)).astype(np.float32)
    calib = np.stack([P2, P2 * np.float32(1.02)])
    ref = jax_rtm.gen_position(*map(jnp.asarray, (kps, dim, rot, calib)))
    out = rtm.gen_position(*map(torch.from_numpy, (kps, dim, rot, calib)))
    for o, r in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_nms_matches_jax_with_valid_mask_and_padding():
    rng = np.random.default_rng(6)
    n = 30
    xy = rng.uniform(0, 50, (2, n, 2))
    wh = rng.uniform(5, 20, (2, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    scores[0, 3] = scores[0, 7]  # a tie
    valid = scores > 0.3
    out_idx, out_valid = nms_lib.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.4,
                                     max_outputs=25, pre_top_k=25,
                                     valid_mask=torch.from_numpy(valid))
    for i in range(2):
        ref_idx, ref_valid = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.4,
                                         max_outputs=25, pre_top_k=25,
                                         valid_mask=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(out_idx[i].numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(out_valid[i].numpy(), np.asarray(ref_valid))
        assert not out_valid[i].all() and (out_idx[i].numpy()[~out_valid[i].numpy()] == -1).all()


# --------------------------------------------------------------------------
# the whole KM3D
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def pair():
    cfg = testing.km3d_detector_cfg(head_features=16, top_k=20)
    jsys = JAX_DETECTORS['KM3D'](EasyDict(copy.deepcopy(cfg)))
    variables = _to_dict(jax.jit(lambda key: jsys.init(key, IMAGE_HW))(jax.random.PRNGKey(0)))
    tsys = DETECTOR_DICT['KM3D'](EasyDict(copy.deepcopy(cfg)), device='cpu')
    skipped = tsys.load_flax_variables(variables)

    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, *IMAGE_HW, 3)).astype(np.float32)
    P2b = np.stack([P2, P2 * np.float32(0.98)])
    gen = torch.Generator().manual_seed(1)
    testing.seed_offset_convs(tsys, gen, 1.0, torch.from_numpy(images))
    testing.calibrate_head_convs(tsys, torch.from_numpy(images), gen)
    for name, m in tsys.net.named_modules():
        if isinstance(m, ModulatedDeformConv):
            _copy_conv_to_flax(variables['params'], f'{name}.Conv_0', m.Conv_0)
        elif name.startswith('KM3DHeadNet_0.') and name.endswith('_out'):
            _copy_conv_to_flax(variables['params'], name, m)
    return jsys, variables, tsys, skipped, (images, P2b)


def _assert_boxes_close(out, ref):
    other = [c for c in range(11) if not CENTRE.start <= c < CENTRE.stop]
    np.testing.assert_allclose(out[:, other], ref[:, other], **BOX_TOL)
    np.testing.assert_allclose(out[:, CENTRE], ref[:, CENTRE], **CENTRE_TOL)


def _jax_raw(jsys):
    return jax.jit(lambda v, im: jsys.net.apply(v, im, train=False))


def test_bridge_loads_strictly_with_nothing_skipped(pair):
    _, variables, tsys, skipped, _ = pair
    assert skipped == []
    n_flax = sum(np.asarray(leaf).size for leaf in jax.tree.leaves(variables))
    n_torch = sum(t.numel() for k, t in tsys.net.state_dict().items()
                  if not k.endswith('num_batches_tracked'))
    assert n_flax == n_torch


def test_every_dcn_takes_the_pallas_kernels_on_the_jax_side(pair):
    _, _, tsys, _, (images, _) = pair
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append((inp[0].shape[2] * inp[0].shape[3],
                                             inp[0].shape[1], out.shape[1])))
        for m in tsys.net.modules() if isinstance(m, ModulatedDeformConv)]
    try:
        dc.reset_launch_counts()
        tsys.predict_raw(torch.from_numpy(images))
    finally:
        for h in hooks:
            h.remove()
    assert dc.LAUNCHES['modulated_deform_conv'] == 0  # CPU: the plain path
    assert len(shapes) == 16
    assert sorted({hw for hw, _, _ in shapes}) == [16, 64, 256, 1024]
    for hw, c_in, c_out in shapes:
        assert _packed_ok(hw, c_in, c_out, jnp.bfloat16), (hw, c_in, c_out)
        assert _packed_f32_ok(hw, c_in, c_out, jnp.float32), (hw, c_in, c_out)


def test_raw_outputs_match_jax_f32(pair):
    jsys, variables, tsys, _, (images, _) = pair
    ref = _jax_raw(jsys)(variables, images)
    out = tsys.predict_raw(torch.from_numpy(images))
    assert sorted(out) == sorted(ref) == sorted(km3d_head.DEFAULT_HEAD_DICT)
    for name in ref:
        r = np.asarray(ref[name])
        assert out[name].shape == r.shape == (BATCH, 16, 64, dict(tsys.head_dict)[name])
        np.testing.assert_allclose(out[name].numpy(), r, rtol=1e-4, atol=1e-4 * r.std(),
                                   err_msg=name)


def test_predict_matches_jax_f32(pair):
    jsys, variables, tsys, _, (images, P2b) = pair
    ref = jax.jit(lambda v, im, p: jsys.predict(v, im, p, max_detections=MAX_DET))(
        variables, images, P2b)
    out = tsys.predict(torch.from_numpy(images), torch.from_numpy(P2b), max_detections=MAX_DET)
    valid = np.asarray(ref['valid'])
    assert 2 * BATCH <= valid.sum() < valid.size  # the seeded head gives NMS work to do
    np.testing.assert_array_equal(out['valid'].numpy(), valid)
    np.testing.assert_array_equal(out['labels'].numpy()[valid], np.asarray(ref['labels'])[valid])
    np.testing.assert_allclose(out['scores'].numpy(), np.asarray(ref['scores']), atol=1e-5)
    _assert_boxes_close(out['bboxes'].numpy()[valid], np.asarray(ref['bboxes'])[valid])


def test_raw_outputs_match_jax_bf16(pair):
    jsys, variables, tsys, _, (images, P2b) = pair
    jsys.cfg.inference_dtype = 'bfloat16'
    tsys.cfg.inference_dtype = 'bfloat16'
    try:
        bf16_vars, (jim,), _ = jsys._inference_cast(variables, [images])
        ref = _jax_raw(jsys)(bf16_vars, jim)
        out = tsys.predict_raw(torch.from_numpy(images))
        det = tsys.predict(torch.from_numpy(images), torch.from_numpy(P2b),
                           max_detections=MAX_DET)
    finally:
        jsys.cfg.inference_dtype = 'float32'
        tsys.cfg.inference_dtype = 'float32'
    for name in ref:
        assert out[name].dtype == torch.bfloat16
        r = np.asarray(ref[name], np.float32)
        err = np.linalg.norm(out[name].float().numpy() - r) / np.linalg.norm(r)
        assert err <= 3e-2, (name, err)
    assert det['bboxes'].dtype == torch.float32 and det['valid'].any()
    assert np.all(np.isfinite(det['bboxes'].numpy()))


def test_batched_decode_equals_per_image(pair):
    """The batched decode (the JAX package vmaps a per-image one) gives
    exactly the per-image results; batched ``predict`` agrees with per-image
    ``predict`` up to the batch-size-dependent conv summation order."""
    _, _, tsys, _, (images, P2b) = pair
    raw = {k: v.float() for k, v in tsys.predict_raw(torch.from_numpy(images)).items()}
    kw = dict(score_thr=0.1, nms_iou_thr=0.5, top_k=20, max_detections=MAX_DET)
    batched = km3d_head.km3d_decode(raw, torch.from_numpy(P2b), IMAGE_HW, **kw)
    full = tsys.predict(torch.from_numpy(images), torch.from_numpy(P2b), max_detections=MAX_DET)
    for i in range(BATCH):
        single = km3d_head.km3d_decode({k: v[i:i + 1] for k, v in raw.items()},
                                       torch.from_numpy(P2b[i:i + 1]), IMAGE_HW, **kw)
        for key in single:
            assert torch.equal(single[key], batched[key][i:i + 1]), key
        one = tsys.predict(torch.from_numpy(images[i:i + 1]), torch.from_numpy(P2b[i:i + 1]),
                           max_detections=MAX_DET)
        assert torch.equal(one['valid'], full['valid'][i:i + 1])
        assert torch.equal(one['labels'], full['labels'][i:i + 1])
        _assert_boxes_close(one['bboxes'].numpy()[0], full['bboxes'].numpy()[i])
