"""The port's int8 stereo inference against the JAX package, on the CPU:
BN folding, calibration, quantization, the bridged ``quant`` artifact, the
fused-block paths and the int8 ``predict``.

One module fixture, shaped like ``tests/test_quant.py``'s: YOLOStereo3D with
ResNet-18, 'Car', the prediction convs randomized (0.005 / 0.02), two
calibration batches of two standard-normal pairs. It runs at 64x160 rather
than 96x320, and the whole-network int8 forwards at batch 1: XLA's CPU int8
convolution takes seconds per 1408-channel conv, and the tier-1 suite has
little time left. The JAX side is jitted; its Pallas block kernel (K8) runs
in interpret mode and the correlation (K1) through its CPU path, as the JAX
package's own tests run them. The ``VD3D_INT8_*`` variables are cleared;
the selection comes from the config.

Tolerances, with their reasons:
* folded weights rtol 1e-6 (one f32 rounding of ``kernel * s``); the folded
  network's output within 1e-5 of its largest value (the f32 BN arithmetic
  moves into the conv sums);
* absmax and ``act_scale`` rtol 1e-5 (f32 forwards of two frameworks);
  ``kernel_q`` and ``w_scale`` bit-equal (the same f32 weights, the same
  f32 arithmetic); the block affines rtol 1e-6;
* whole-network raw outputs of the bridged artifact, f32 compute: largest
  difference <= 1e-2 of the output's scale and >= 99% of the elements
  within 1e-4 of it (the s32 sums are exact, but an f32 rounding difference
  before a quantize can flip an int8 level, which later layers carry);
* the fused blocks alone, on the same inputs: the JAX package's block gate
  (<= 0.1% of the elements beyond 1e-4 of the scale, none beyond 0.02);
* int8 predict against JAX's int8 predict: the JAX package's decode gates
  (valid count within 2, the top-3 boxes matched at IoU > 0.7, scores within
  0.05); against the port's own f32 predict: raw error < 5% of the scale.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from visualdet3d_tpu.models import fold_bn as jax_fold_bn
from visualdet3d_tpu.models import quant as jq
from visualdet3d_tpu.ops.int8_block import int8_basic_block_fused
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
from visualdet3d_tpu.testing import stereo3d_detector_cfg, write_synthetic_priors
import visualdet3d_tpu.models.detectors.yolostereo3d  # noqa: F401
from visualdet3d_tpu_torch import convert
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.models import quant as tq
from visualdet3d_tpu_torch.ops import cost_volume as cv
from visualdet3d_tpu_torch.ops import int8_block as ib
from visualdet3d_tpu_torch.ops import int8_conv as ic
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


HW = (64, 160)
ENV = ('VD3D_INT8_ALL', 'VD3D_INT8_S2D', 'VD3D_INT8_MINCH', 'VD3D_INT8_BLOCK',
       'VD3D_INT8_BLOCK_MAXCH')
P2_ONE = np.array([[721.5, 0, 80, 44.8], [0, 721.5, 32, 0.2], [0, 0, 1, 0.003]], np.float32)
CONFIGS = {'default': (False, False), 'int8_all': (True, False), 'int8_s2d': (False, True)}


def _np_tree(tree):
    if hasattr(tree, 'items'):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flax_variables(net, rng):
    """The port's network as a flax ``{params, batch_stats}`` tree (the
    weight bridge backwards: OIHW -> HWIO, OIDHW -> DHWIO), with the
    BatchNorms' statistics and affines randomized so that folding moves
    every number. Saves the JAX package's init, a ten-second compile."""
    import torch.nn as tnn
    params, stats = {}, {}

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value

    for name, mod in net.named_modules():
        path = tuple(name.split('.'))
        if isinstance(mod, (tnn.Conv2d, tnn.Conv3d)):
            perm = (2, 3, 1, 0) if mod.weight.dim() == 4 else (2, 3, 4, 1, 0)
            put(params, path + ('kernel',), mod.weight.detach().numpy().transpose(perm).copy())
            if mod.bias is not None:
                put(params, path + ('bias',), mod.bias.detach().numpy().copy())
        elif isinstance(mod, tnn.modules.batchnorm._BatchNorm):
            c = mod.num_features
            put(params, path + ('scale',), rng.uniform(0.5, 1.5, c).astype(np.float32))
            put(params, path + ('bias',), (0.1 * rng.standard_normal(c)).astype(np.float32))
            put(stats, path + ('mean',), (0.1 * rng.standard_normal(c)).astype(np.float32))
            put(stats, path + ('var',), rng.uniform(0.5, 2.0, c).astype(np.float32))
    return {'params': params, 'batch_stats': stats}


def _set_select(cfgs, int8_all, s2d):
    for cfg in cfgs:
        cfg.int8_all, cfg.int8_s2d = int8_all, s2d


def _build(mp, tmp_path_factory):
    pre = str(tmp_path_factory.mktemp('pre'))
    write_synthetic_priors(pre, ('Car',), num_ratios=3)
    cfg = stereo3d_detector_cfg(pre, obj_types=('Car',), depth=18)
    jsys = JAX_DETECTORS[cfg.name](cfg)
    jsys.anchor_pack(HW)
    tsys = DETECTOR_DICT['Stereo3D'](EasyDict(copy.deepcopy(cfg)), device='cpu')
    rng = np.random.default_rng(7)
    variables = _flax_variables(tsys.net, rng)
    head = variables['params']['StereoHead_0']
    for node, scale in ((head['Conv_0'], 0.005), (head['_ClsBranch_0']['Conv_2'], 0.02)):
        node['kernel'] = (scale * rng.standard_normal(node['kernel'].shape)).astype(np.float32)
    tsys.load_flax_variables(variables)
    drng = np.random.default_rng(0)
    P2 = np.tile(P2_ONE, (2, 1, 1))
    batches = [(drng.standard_normal((2, *HW, 3)).astype(np.float32),
                drng.standard_normal((2, *HW, 3)).astype(np.float32), P2) for _ in range(2)]
    one = (batches[0][0][:1], batches[0][1][:1], P2[:1])
    unfolded = [t.clone() for t in tsys.predict_raw(one[0], one[1])]

    # the JAX fold, recording the pairs its own detection finds
    jax_pairs = []
    detect = jax_fold_bn.detect_conv_bn_pairs

    def recording(*args, **kwargs):
        pairs = detect(*args, **kwargs)
        jax_pairs.extend(pairs)
        return pairs
    mp.setattr(jax_fold_bn, 'detect_conv_bn_pairs', recording)
    folded = _np_tree(jsys.fold_inference_variables(variables, HW))
    mp.setattr(jax_fold_bn, 'detect_conv_bn_pairs', detect)
    port_pairs = tsys.fold_inference_variables(HW)
    port_folded = {k: v.clone() for k, v in tsys.net.state_dict().items()}
    folded_raw = [t.clone() for t in tsys.predict_raw(one[0], one[1])]
    # from here on both frameworks hold the same (JAX-folded) weights
    tsys.load_flax_variables(folded)

    cfgs = (jsys.cfg, tsys.cfg)
    _set_select(cfgs, True, True)  # calibrate the union of the three selections
    jax_absmax = jsys.calibrate_int8(folded, batches)
    port_absmax = tsys.calibrate_int8(batches)
    quants = {}
    for name, (int8_all, s2d) in CONFIGS.items():
        _set_select(cfgs, int8_all, s2d)
        quants[name] = (jsys.quantize_int8(folded, jax_absmax, HW), tsys.quantize_int8(port_absmax))
    _set_select(cfgs, True, False)  # the deployment's: configs/stereo3d_int8.py
    qvars = quants['int8_all'][0]
    tsys.set_int8_quant(convert.quant_from_flax(qvars[jq.QUANT_COLLECTION]))
    return dict(jsys=jsys, tsys=tsys, variables=variables, folded=folded, qvars=qvars,
                batches=batches, one=one, unfolded=unfolded, folded_raw=folded_raw,
                port_folded=port_folded, jax_pairs=jax_pairs, port_pairs=port_pairs,
                jax_absmax=jax_absmax, port_absmax=port_absmax, quants=quants)


@pytest.fixture(scope='module')
def fx(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for key in ENV:
            mp.delenv(key, raising=False)
        return _build(mp, tmp_path_factory)


@pytest.fixture(autouse=True)
def _no_int8_env(monkeypatch):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)


def _jax_raw(fx, interceptor, images):
    jsys = fx['jsys']

    def apply(v, left, right, p):
        with nn.intercept_methods(interceptor):
            cls, reg, _ = jsys.net.apply(v, left, right, p, train=False)
        return cls, reg
    return [np.asarray(t, np.float32) for t in jax.jit(apply)(fx['qvars'], *images)]


def _port_raw(fx, net, images):
    tsys = fx['tsys']
    with torch.no_grad():
        out = net(tsys._images(images[0], torch.float32), tsys._images(images[1], torch.float32))
    return [t.float().numpy() for t in out]


def _bridge_gate(got, ref, what):
    scale = float(np.abs(ref).max())
    d = np.abs(got - ref)
    within = float((d <= 1e-4 * scale).mean())
    assert float(d.max()) <= 1e-2 * scale and within >= 0.99, (what, float(d.max()), scale, within)


def _block_gate(got, ref, what):
    scale = float(np.abs(ref).max()) or 1.0
    d = np.abs(got - ref)
    frac = float((d > 1e-4 * scale).mean())
    assert frac <= 1e-3 and float(d.max()) <= 0.02 * scale, (what, frac, float(d.max()), scale)


def test_fold_finds_the_jax_pairs(fx):
    assert len(fx['jax_pairs']) >= 20
    assert sorted(fx['port_pairs']) == sorted(fx['jax_pairs'])


def test_folded_weights_match_jax(fx):
    ref, _ = convert.flax_to_state_dict(fx['folded'], fx['tsys'].TRAIN_ONLY_PARAMS)
    port = fx['port_folded']
    assert sorted(ref) == sorted(port)
    for key, value in ref.items():
        if value.is_floating_point():
            np.testing.assert_allclose(port[key].numpy(), value.numpy(), rtol=1e-6, atol=1e-12,
                                       err_msg=key)


def test_folded_network_matches_unfolded(fx):
    for got, ref in zip(fx['folded_raw'], fx['unfolded']):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_calibration_matches_jax(fx):
    jabs, pabs = fx['jax_absmax'], fx['port_absmax']
    assert len(jabs) >= 20 and sorted(pabs) == sorted(jabs)
    for path, value in jabs.items():
        np.testing.assert_allclose(pabs[path], value, rtol=1e-5, err_msg=str(path))


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_quantization_matches_jax(fx, config):
    qvars, port = fx['quants'][config]
    jax_flat = jq.flatten_quant(qvars[jq.QUANT_COLLECTION])
    port_flat = tq.flatten_quant(port)
    assert sorted(port_flat) == sorted(jax_flat)
    deny = set(fx['jsys'].int8_deny)
    assert (deny <= set(port_flat)) == (config == 'int8_all')
    stride2 = ('ResNet_0', 'layer2_0', 'Conv_0')  # a 3x3 stride-2 conv of 64 channels
    assert (stride2 in port_flat) == (config == 'int8_s2d')
    for path, entry in jax_flat.items():
        got = port_flat[path]
        np.testing.assert_array_equal(got['kernel_q'].numpy(),
                                      np.asarray(entry['kernel_q']).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(got['w_scale'].numpy(), np.asarray(entry['w_scale']))
        np.testing.assert_allclose(float(got['act_scale']), float(entry['act_scale']), rtol=1e-5)
        assert ('bias' in got) == ('bias' in entry)
        if 'bias' in entry:
            np.testing.assert_array_equal(got['bias'].numpy(), np.asarray(entry['bias']))
    jax_blocks = jq.collect_block_entries(qvars[jq.QUANT_COLLECTION], jax_flat)
    port_blocks = tq.collect_block_entries(port)
    assert sorted(port_blocks) == sorted(jax_blocks) and len(jax_blocks) >= 2
    for bp, be in jax_blocks.items():
        for key in ('bn1_scale', 'bn1_shift', 'bn2_scale', 'bn2_shift'):
            np.testing.assert_allclose(port_blocks[bp][key].numpy(), np.asarray(be[key]),
                                       rtol=1e-6, atol=1e-7, err_msg=f'{bp} {key}')


def test_bridge_carries_the_jax_artifact(fx):
    bridged = fx['tsys'].int8_quant
    _, port = fx['quants']['int8_all']
    assert sorted(bridged) == sorted(port)
    for path, entry in bridged.items():
        assert sorted(entry) == sorted(port[path])
        if 'kernel_q' in entry:
            assert entry['kernel_q'].dtype == torch.int8 and entry['kernel_q'].is_contiguous()
            assert torch.equal(entry['kernel_q'], port[path]['kernel_q'])
            assert entry['act_scale'].dim() == 0 and entry['w_scale'].dtype == torch.float32


@pytest.mark.parametrize('impl', ['', 'pallas'])
def test_int8_raw_outputs_match_jax(fx, impl):
    """The bridged artifact, f32 compute: the per-conv path and the fused
    64-channel blocks (K8's plain version here; the Pallas kernel in
    interpret mode there) against the JAX package's interceptor."""
    qflat = jq.flatten_quant(fx['qvars'][jq.QUANT_COLLECTION])
    blocks = jq.collect_block_entries(fx['qvars'][jq.QUANT_COLLECTION], qflat) if impl else None
    ref = _jax_raw(fx, jq.int8_interceptor(qflat, jnp.float32, blocks=blocks, block_impl=impl),
                   fx['one'])
    net = fx['tsys'].int8_net(torch.float32, impl)
    n_fused = sum(isinstance(m, tq.Int8BasicBlock) for m in net.modules())
    assert n_fused == (2 if impl else 0)  # layer1_0 and layer1_1 of ResNet-18
    got = _port_raw(fx, net, fx['one'])
    for name, g, r in zip(('cls', 'reg'), got, ref):
        assert g.shape == r.shape
        _bridge_gate(g, r, f'{impl or "per conv"} {name}')


def test_int8_block_chains_match_jax(fx):
    """The 'xla' chain with the float residual, block by block, on the
    bridged entries: the port's module against ``quant._int8_basic_block``."""
    qflat = jq.flatten_quant(fx['qvars'][jq.QUANT_COLLECTION])
    jax_blocks = jq.collect_block_entries(fx['qvars'][jq.QUANT_COLLECTION], qflat)
    port_blocks = tq.collect_block_entries(fx['tsys'].int8_quant)
    rng = np.random.default_rng(5)
    for bp, be in sorted(jax_blocks.items()):
        c = np.asarray(be['e1']['kernel_q']).shape[2]
        x = rng.standard_normal((1, 3, 5, c)).astype(np.float32)
        ref = np.asarray(jq._int8_basic_block(jnp.asarray(x), be, jnp.float32))
        mod = tq.Int8BasicBlock(port_blocks[bp], 'xla', torch.float32)
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
        _block_gate(got, ref, bp)


def test_xla_block_path_matches_per_conv(fx):
    """The whole network with every fusable block as the 'xla' chain against
    the per-conv path: the JAX package's gate (1e-3 of the scale), as the
    two differ only by the reassociated epilogue."""
    tsys = fx['tsys']
    per_conv = _port_raw(fx, tsys.int8_net(torch.float32, ''), fx['one'])
    chain = _port_raw(fx, tsys.int8_net(torch.float32, 'xla'), fx['one'])
    for a, b in zip(per_conv, chain):
        assert float(np.abs(a - b).max()) < 1e-3 * float(np.abs(a).max())


def test_fused_block_plain_matches_jax_pallas(fx):
    """K8's plain version against the JAX package's Pallas kernel (interpret
    mode) on the real 64-channel block entries."""
    qflat = jq.flatten_quant(fx['qvars'][jq.QUANT_COLLECTION])
    jax_blocks = jq.collect_block_entries(fx['qvars'][jq.QUANT_COLLECTION], qflat)
    port_blocks = tq.collect_block_entries(fx['tsys'].int8_quant)
    small = [bp for bp, be in sorted(jax_blocks.items())
             if np.asarray(be['e1']['kernel_q']).shape[2] == 64]
    assert len(small) == 2, small
    rng = np.random.default_rng(3)
    for bp in small:
        x = rng.standard_normal((2, 12, 20, 64)).astype(np.float32)
        ref = np.asarray(int8_basic_block_fused(jnp.asarray(x), jax_blocks[bp], jnp.float32))
        pb = port_blocks[bp]
        params = ib.block_params(pb['e1'], pb['e2'], pb['bn1_scale'], pb['bn1_shift'],
                                 pb['bn2_scale'], pb['bn2_shift'])
        xq = ic.quantize_act(torch.from_numpy(x), 1.0 / pb['e1']['act_scale'])
        got = ib.int8_basic_block(xq, pb['e1']['kernel_q'], pb['e2']['kernel_q'], params,
                                  torch.float32).numpy()
        _block_gate(got, ref, bp)


def _iou(a, b):
    ix1, iy1 = np.maximum(a[:2], b[:2])
    ix2, iy2 = np.minimum(a[2:4], b[2:4])
    inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-6)


def _decode_gate(ref, got, n_images):
    matched = 0
    for b in range(n_images):
        vr, vg = np.asarray(ref['valid'][b]), np.asarray(got['valid'][b])
        assert abs(int(vr.sum()) - int(vg.sum())) <= 2, (b, vr.sum(), vg.sum())
        boxes_g = np.asarray(got['bboxes'][b])[vg, :4]
        scores_g = np.asarray(got['scores'][b])[vg]
        for i in range(min(3, int(vr.sum()))):
            br = np.asarray(ref['bboxes'][b][i][:4])
            ious = np.array([_iou(br, bg) for bg in boxes_g])
            j = int(ious.argmax())
            assert ious[j] > 0.7, (b, i, br, boxes_g[ious.argsort()[-3:]])
            assert abs(float(ref['scores'][b][i]) - float(scores_g[j])) < 0.05
            matched += 1
    return matched


def test_int8_predict_matches_jax(fx):
    """int8 predict (bf16 remainder, the bf16 correlation) against the JAX
    package's int8 predict on the same artifact, batch 2."""
    jsys, tsys = fx['jsys'], fx['tsys']
    left, right, P2 = fx['batches'][0]
    jsys.cfg.inference_dtype = tsys.cfg.inference_dtype = 'int8'
    try:
        ref = jax.jit(lambda v, a, b, c: jsys.predict(v, a, b, c, max_detections=16))(
            fx['qvars'], left, right, P2)
        cv.reset_launch_counts()
        ic.reset_launch_counts()
        got = tsys.predict(torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(P2),
                           max_detections=16)
    finally:
        jsys.cfg.inference_dtype = tsys.cfg.inference_dtype = 'float32'
    assert ic.LAUNCHES['int8_conv2d'] == 0 and cv.LAUNCHES['correlation_volume_interleaved'] == 0
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert _decode_gate(ref, got, 2) >= 2


def test_int8_predict_close_to_own_f32(fx):
    """The port's int8 raw predictions (bf16 remainder) against its own f32
    ones on the folded network: error < 5% of the output scale."""
    tsys = fx['tsys']
    left, right, _ = fx['batches'][0]
    ref = [t.float() for t in tsys.predict_raw(left, right)]
    tsys.cfg.inference_dtype = 'int8'
    try:
        got = [t.float() for t in tsys.predict_raw(left, right)]
    finally:
        tsys.cfg.inference_dtype = 'float32'
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) < 0.05 * float(r.abs().max())
