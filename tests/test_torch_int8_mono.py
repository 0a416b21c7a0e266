"""int8 inference of the mono families (GAC, Yolo3D, KM3D, MonoFlex) on the
CPU, against the JAX package's ``Int8InferenceMixin`` and against the
port's own f32.

* GAC and Yolo3D (``tests/helpers.py::tiny_mono_cfg``: ResNet-18, 64x160,
  32-wide towers, ``int8_min_channels`` 32 on both sides so that the towers
  quantize): the seeded port weights in a flax tree, folded by the JAX
  package and loaded back; the calibration absmax (rtol 1e-5: f32 forwards
  of two frameworks) and the artifact (paths, ``kernel_q`` and ``w_scale``
  bit for bit, ``act_scale`` rtol 1e-5, bias, ``block_fuse``) equal to
  JAX's; for Yolo3D the one difference is the deliberate one: the port keeps
  ``AnchorBasedDetection3DHead_0/Conv_1`` (its regression output) in
  floats where the JAX deny list names a ``Conv_2`` that does not exist.
  Then JAX's artifact carried across (``convert.quant_from_flax``): the raw
  outputs in f32 compute against the JAX interceptor's (the gate of
  ``tests/test_torch_int8.py``: largest difference 1e-2 of the scale, 99%
  within 1e-4 of it) and the dtype every conv, BatchNorm, DCN and
  ``LookGround`` computes in under int8 inference equal to JAX's (traced
  with ``jax.eval_shape``, no compile): the quantized convs return bf16,
  so GAC's tower is bf16 from its first quantized conv on.
* KM3D (DLA-34 at 32x96, the 64-channel bound): the absmax and the artifact
  equal to JAX's, ``block_fuse`` entries of DLA's ``BasicBlock``s included,
  which the port's int8 copy must not fuse; KM3D and MonoFlex in int8 with
  at least 10 quantized convs, none inside a ``ModulatedDeformConv``, the
  DCNs in bf16, and scores within 0.05 of their own f32 (the gates of the
  JAX package's ``test_km3d_int8_smoke``).
* the fused-block bias rule: a block whose convs have a bias gets no
  ``block_fuse`` entry.
* ``configs/yolo3d_gac.py`` (depth 18, 64x256, 32-wide towers, int8) on a
  ``testing.write_synthetic_kitti`` tree: ``cli.quantize`` then
  ``cli.eval --quantized_path`` writes the files that calibrating on the
  fly writes, and the int8 evaluation's AP is within 0.2 of the f32
  evaluation's (the JAX package's synthetic-AP gate; the port against
  itself).
"""
import copy
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as flax_nn

from visualdet3d_tpu.models import quant as jq
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
import visualdet3d_tpu.models.detectors.km3d  # noqa: F401
import visualdet3d_tpu.models.detectors.yolo3d  # noqa: F401
from visualdet3d_tpu_torch import checkpoint, convert, testing
from visualdet3d_tpu_torch.cli import eval as eval_cli
from visualdet3d_tpu_torch.cli import imdb_precompute_3d
from visualdet3d_tpu_torch.cli import quantize as quantize_cli
from visualdet3d_tpu_torch.config import EasyDict, cfg_from_file
from visualdet3d_tpu_torch.models import blocks
from visualdet3d_tpu_torch.models import quant as tq
from visualdet3d_tpu_torch.models.backbones.resnet import BasicBlock
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.ops import int8_conv as ic
from visualdet3d_tpu_torch.registry import DETECTOR_DICT
import visualdet3d_tpu_torch.models  # noqa: F401

from helpers import tiny_mono_cfg, write_fake_priors
from test_torch_cli_eval import _ap_table, _result_files
from test_torch_cli_train import _write_config
from test_torch_gac import flax_from_port, sample_P2
from test_torch_int8 import ENV, _bridge_gate, _np_tree

HW = (64, 160)
KM3D_HW = (32, 96)
HEADS = ('GroundAwareYolo3D', 'Yolo3D')
MIN_CHANNELS = 32
YOLO3D_REG = ('AnchorBasedDetection3DHead_0', 'Conv_1')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_int8_env(monkeypatch):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)


def _t(x):
    return torch.from_numpy(np.array(x))


def _check_artifact(jax_quant, port, skip=()):
    """Paths, ``kernel_q``, ``w_scale`` and the bias bit for bit,
    ``act_scale`` rtol 1e-5, the ``block_fuse`` affines rtol 1e-6; the
    JAX paths in ``skip`` are the deliberate differences."""
    jax_flat = {p: e for p, e in jq.flatten_quant(jax_quant).items() if p not in skip}
    port_flat = tq.flatten_quant(port)
    assert sorted(port_flat) == sorted(jax_flat)
    for path, entry in jax_flat.items():
        got = port_flat[path]
        np.testing.assert_array_equal(got['kernel_q'].numpy(),
                                      np.asarray(entry['kernel_q']).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(got['w_scale'].numpy(), np.asarray(entry['w_scale']))
        np.testing.assert_allclose(float(got['act_scale']), float(entry['act_scale']), rtol=1e-5)
        assert ('bias' in got) == ('bias' in entry), path
        if 'bias' in entry:
            np.testing.assert_array_equal(got['bias'].numpy(), np.asarray(entry['bias']))
    jax_blocks = jq.collect_block_entries(jax_quant, jq.flatten_quant(jax_quant))
    port_blocks = tq.collect_block_entries(port)
    assert sorted(port_blocks) == sorted(jax_blocks)
    for bp, be in jax_blocks.items():
        for key in ('bn1_scale', 'bn1_shift', 'bn2_scale', 'bn2_shift'):
            np.testing.assert_allclose(port_blocks[bp][key].numpy(), np.asarray(be[key]),
                                       rtol=1e-6, atol=1e-7, err_msg=f'{bp} {key}')
    return jax_flat, port_blocks


DTYPE_KINDS = (torch.nn.Conv2d, tq.Int8Conv2d, blocks.BatchNorm2d, blocks.LookGround,
               blocks.ModulatedDeformConv)
JAX_KINDS = ('Conv', 'BatchNorm', 'LookGround', 'ModulatedDeformConv')


def _jax_int8_dtypes(jsys, qvars, images, P2):
    """{module path: output dtype} of the JAX package's int8 forward,
    traced (no compile); the recorder is entered first, so that it sees
    the int8 interceptor's outputs."""
    seen = {}

    def record(next_fn, a, kw, context):
        out = next_fn(*a, **kw)
        if context.method_name == '__call__' and type(context.module).__name__ in JAX_KINDS:
            seen['.'.join(context.module.path)] = jnp.dtype(out.dtype).name
        return out

    def traced(v, im, p):
        v, (im,), ctx = jsys._inference_cast(v, [im])
        with flax_nn.intercept_methods(record), ctx:
            return jsys.net.apply(v, im, p, train=False)
    jsys.cfg.inference_dtype = 'int8'
    try:
        out = jax.eval_shape(traced, qvars, images, P2)
    finally:
        jsys.cfg.inference_dtype = 'float32'
    return seen, [jnp.dtype(o.dtype).name for o in out]


def _port_int8_dtypes(tsys, images, P2):
    seen, handles = {}, []
    net = tsys.inference_net()
    for name, m in net.named_modules():
        if isinstance(m, DTYPE_KINDS):
            def hook(mod, args, out, name=name):
                seen[name] = str(out.dtype).replace('torch.', '')
            handles.append(m.register_forward_hook(hook))
    try:
        out = tsys.predict_raw(images, P2)
    finally:
        for h in handles:
            h.remove()
    return seen, [str(o.dtype).replace('torch.', '') for o in out]


@pytest.fixture(scope='module', params=HEADS)
def mono(request, tmp_path_factory):
    name = request.param
    pre = str(tmp_path_factory.mktemp('pre'))
    write_fake_priors(pre, ['Car'])
    cfg = EasyDict(copy.deepcopy(tiny_mono_cfg(pre, ground_aware=name == HEADS[0])))
    cfg.int8_min_channels = MIN_CHANNELS
    jsys = JAX_DETECTORS[name](copy.deepcopy(cfg))
    tsys = DETECTOR_DICT[name](copy.deepcopy(cfg), device='cpu')
    rng = np.random.default_rng(31)
    images = rng.standard_normal((2, *HW, 3)).astype(np.float32)
    P2 = sample_P2(2)
    testing.prepare_mono_for_predict(tsys, _t(images), _t(P2), torch.Generator().manual_seed(32),
                                     offset_std=1.0)
    shapes = jax.eval_shape(lambda k: jsys.init(k, HW, batch_size=1), jax.random.PRNGKey(0))
    variables = flax_from_port(shapes, tsys.net)
    folded = _np_tree(jsys.fold_inference_variables(variables, HW))
    assert tsys.load_flax_variables(folded) == []
    batches = [(rng.standard_normal((2, *HW, 3)).astype(np.float32), P2) for _ in range(2)]
    jax_absmax = jsys.calibrate_int8(folded, batches)
    port_absmax = tsys.calibrate_int8(batches)
    qvars = jsys.quantize_int8(folded, jax_absmax, HW)
    port_quant = tsys.quantize_int8(port_absmax)

    # JAX's artifact on the port: the raw outputs in f32 compute, one image
    one = (images[:1], P2[:1])
    qflat = jq.flatten_quant(qvars[jq.QUANT_COLLECTION])

    def apply(v, im, p):
        with flax_nn.intercept_methods(jq.int8_interceptor(qflat, jnp.float32)):
            return jsys.net.apply(v, im, p, train=False)
    j_raw = [np.asarray(t, np.float32) for t in jax.jit(apply)(qvars, *one)]
    tsys.set_int8_quant(convert.quant_from_flax(qvars[jq.QUANT_COLLECTION]))
    with torch.no_grad():
        t_raw = [t.float().numpy() for t in tsys.int8_net(torch.float32)(
            tsys._images(one[0], torch.float32), _t(one[1]))]
    j_dtypes = _jax_int8_dtypes(jsys, qvars, jnp.asarray(one[0]), jnp.asarray(one[1]))
    tsys.cfg.inference_dtype = 'int8'
    ic.reset_launch_counts()
    t_dtypes = _port_int8_dtypes(tsys, _t(one[0]), _t(one[1]))
    launches = dict(ic.LAUNCHES)
    tsys.cfg.inference_dtype = 'float32'
    return dict(name=name, jsys=jsys, tsys=tsys, jax_absmax=jax_absmax, port_absmax=port_absmax,
                qvars=qvars, port_quant=port_quant, raw=(j_raw, t_raw),
                dtypes=(j_dtypes, t_dtypes), launches=launches)


def test_calibration_matches_jax(mono):
    jabs, pabs = mono['jax_absmax'], mono['port_absmax']
    deny_gap = {YOLO3D_REG} if mono['name'] == 'Yolo3D' else set()
    assert len(pabs) >= 10 and set(jabs) - set(pabs) == deny_gap and set(pabs) <= set(jabs)
    for path, value in pabs.items():
        np.testing.assert_allclose(value, jabs[path], rtol=1e-5, err_msg=str(path))


def test_artifact_matches_jax(mono):
    """The artifacts are equal; for Yolo3D JAX has one entry more, the
    regression output conv the port denies."""
    jax_quant = mono['qvars'][jq.QUANT_COLLECTION]
    skip = (YOLO3D_REG,) if mono['name'] == 'Yolo3D' else ()
    jax_flat, port_blocks = _check_artifact(jax_quant, mono['port_quant'], skip)
    port_flat = tq.flatten_quant(mono['port_quant'])
    head = 'GroundAwareHead_0' if mono['name'] == HEADS[0] else 'AnchorBasedDetection3DHead_0'
    assert (head, 'Conv_0') in port_flat and len(port_blocks) >= 2
    for path in mono['tsys'].int8_deny:
        assert path not in port_flat
    if mono['name'] == 'Yolo3D':
        assert YOLO3D_REG in jq.flatten_quant(jax_quant)  # JAX quantizes it (its deny misses)
    else:
        assert (head, 'Conv_2') not in jq.flatten_quant(jax_quant)


def test_int8_raw_outputs_match_jax(mono):
    """The bridged JAX artifact (Yolo3D's regression conv quantized, as
    JAX's is), f32 compute, against the JAX interceptor."""
    ref, got = mono['raw']
    for what, g, r in zip(('cls', 'reg'), got, ref):
        assert g.shape == r.shape
        _bridge_gate(g, r, f'{mono["name"]} {what}')


def test_int8_dtypes_match_jax(mono):
    """Every module computes in JAX's dtype under int8 inference, and the
    outputs too: the quantized convs return bf16, so GAC's tower after
    ``LookGround`` (f32 in bf16 inference) is bf16 from its first
    (quantized) conv, and its denied regression conv runs in bf16 on bf16
    weights."""
    (j_mods, j_out), (t_mods, t_out) = mono['dtypes']
    assert t_mods == j_mods and t_out == j_out
    assert t_out == ['bfloat16', 'bfloat16']
    if mono['name'] == HEADS[0]:
        assert j_mods['GroundAwareHead_0.Conv_0'] == 'bfloat16'
        assert j_mods['GroundAwareHead_0.Conv_2'] == 'bfloat16'
    else:
        assert j_mods['AnchorBasedDetection3DHead_0.ModulatedDeformConv_0'] == 'bfloat16'
    assert mono['launches']['int8_conv2d'] == 0  # the CPU: the plain versions


# --------------------------------------------------------------------------
# KM3D and MonoFlex
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def km3d():
    cfg = EasyDict(copy.deepcopy(testing.km3d_detector_cfg(head_features=64)))
    jsys = JAX_DETECTORS['KM3D'](copy.deepcopy(cfg))
    tsys = DETECTOR_DICT['KM3D'](copy.deepcopy(cfg), device='cpu')
    shapes = jax.eval_shape(lambda k: jsys.init(k, KM3D_HW, batch_size=1), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(33)
    with torch.no_grad():  # BN statistics that folding moves
        for m in tsys.net.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
    variables = flax_from_port(shapes, tsys.net)
    folded = _np_tree(jsys.fold_inference_variables(variables, KM3D_HW))
    assert tsys.load_flax_variables(folded) == []
    rng = np.random.default_rng(34)
    batches = [(rng.standard_normal((1, *KM3D_HW, 3)).astype(np.float32),) for _ in range(2)]
    jax_absmax = jsys.calibrate_int8(folded, batches)
    port_absmax = tsys.calibrate_int8(batches)
    qvars = jsys.quantize_int8(folded, jax_absmax, KM3D_HW)
    return dict(tsys=tsys, jax_absmax=jax_absmax, port_absmax=port_absmax, qvars=qvars,
                port_quant=tsys.quantize_int8(port_absmax), batches=batches)


def test_km3d_artifact_matches_jax(km3d):
    jabs, pabs = km3d['jax_absmax'], km3d['port_absmax']
    assert sorted(pabs) == sorted(jabs)
    for path, value in jabs.items():
        np.testing.assert_allclose(pabs[path], value, rtol=1e-5, err_msg=str(path))
    _, port_blocks = _check_artifact(km3d['qvars'][jq.QUANT_COLLECTION], km3d['port_quant'])
    assert len(port_blocks) >= 2 and all(bp[0] == 'KM3DCore_0' for bp in port_blocks)


@pytest.mark.parametrize('name', ['KM3D', 'MonoFlex'])
def test_int8_km3d_and_monoflex_stay_near_their_f32(km3d, name):
    """At least 10 quantized convs, none inside a ``ModulatedDeformConv``;
    the int8 copy fuses no DLA block (``_is_fusable_basic_block`` takes
    the resnet ``BasicBlock`` alone) and runs its DCNs in bf16; the scores
    within 0.05 of the f32 ones."""
    if name == 'KM3D':
        tsys = km3d['tsys']
    else:
        tsys = DETECTOR_DICT['MonoFlex'](testing.monoflex_detector_cfg(head_features=64),
                                         device='cpu')
        tsys.fold_inference_variables(KM3D_HW)
        tsys.quantize_int8(tsys.calibrate_int8(km3d['batches']))
    qflat = tq.flatten_quant(tsys.int8_quant)
    assert len(qflat) >= 10
    assert not any(any(c.startswith('ModulatedDeformConv') for c in p) for p in qflat)
    tsys.cfg.int8_block = 'pallas'
    tsys.cfg.inference_dtype = 'int8'
    try:
        net = tsys.inference_net()
        assert not any(isinstance(m, tq.Int8BasicBlock) for m in net.modules())
        dcn_dtypes = []
        handles = [m.register_forward_hook(lambda mod, a, out: dcn_dtypes.append(out.dtype))
                   for m in net.modules() if isinstance(m, blocks.ModulatedDeformConv)]
        images = _t(km3d['batches'][0][0])
        P2 = _t(testing.KITTI_P2[None])
        dc.reset_launch_counts()
        out_q = tsys.predict(images, P2, max_detections=8)
        for h in handles:
            h.remove()
    finally:
        tsys.cfg.inference_dtype = 'float32'
        tsys.cfg.int8_block = False
    assert dcn_dtypes and set(dcn_dtypes) == {torch.bfloat16}
    out_f = tsys.predict(images, P2, max_detections=8)
    np.testing.assert_allclose(out_q['scores'].numpy(), out_f['scores'].numpy(), atol=0.05)


def test_block_fusion_skips_a_block_with_a_conv_bias():
    """The fused chain has no place for a conv bias: a resnet block whose
    conv carries one gets no ``block_fuse`` entry, while the same block
    without it does."""
    for bias in (False, True):
        block = BasicBlock(8, 8)
        if bias:
            block.Conv_1.bias = torch.nn.Parameter(torch.full((8,), 0.1))
        with torch.no_grad():
            for bn in (block.BatchNorm_0, block.BatchNorm_1):
                bn.running_var.fill_(1.0 - 1e-5)  # the pure affine folding leaves
        net = torch.nn.Sequential()
        net.add_module('block', block)
        select = lambda mod, c, path: tq.default_select(mod, c, path, frozenset(),  # noqa: E731
                                                        min_channels=8)
        absmax = {('block', 'Conv_0'): 2.0, ('block', 'Conv_1'): 3.0}
        quant = tq.quantize_variables(net, absmax, select)
        assert len(tq.flatten_quant(quant)) == 2
        assert (('block', tq.BLOCK_FUSE_KEY) in quant) == (not bias)


# --------------------------------------------------------------------------
# the quantize and eval CLIs on a GAC int8 config; the synthetic-AP gate
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def gac_tree(tmp_path_factory):
    """``configs/yolo3d_gac.py`` at depth 18, 64x256, 32-wide towers,
    ``inference_dtype='int8'`` and ``int8_min_channels`` 32, on a
    ``testing.write_synthetic_kitti`` tree of 8 frames (4 to train on, 4 to
    evaluate), synthetic anchor priors, and a checkpoint of a seeded system
    made ready to predict on the validation frames (the class logits'
    top 2% above sigmoid(1.5))."""
    sys.modules['torch.utils.tensorboard'] = None
    work = tmp_path_factory.mktemp('gac')
    root = str(work / 'kitti')
    testing.write_synthetic_kitti(root, 8, seed=5)
    split = testing.write_split_files(str(work / 'split'), [0, 1, 2, 3], [4, 5, 6, 7])
    settings = {
        'path.data_path': root, 'path.preprocessed_path': str(work / 'output'),
        'path.log_path': str(work / 'log'), 'path.checkpoint_path': str(work / 'checkpoint'),
        'data.train_split_file': split[0], 'data.val_split_file': split[1],
        'data.batch_size': 2, 'data.num_workers': 0, 'data.rgb_shape': [64, 256, 3],
        'data.train_augmentation.3.keywords.size': [64, 256],
        'data.test_augmentation.2.keywords.size': [64, 256],
        'detector.backbone.depth': 18, 'detector.backbone.pretrained': False,
        'detector.head.layer_cfg.cls_feature_size': 32,
        'detector.head.layer_cfg.reg_feature_size': 32,
        'detector.head.preprocessed_path': str(work / 'output'),
        'detector.head.test_cfg.post_optimization': False,
        'detector.inference_dtype': 'int8', 'detector.int8_min_channels': MIN_CHANNELS,
        'detector.calibration': {'num_batches': 2, 'batch_size': 2}}
    config = _write_config(work / 'gac_int8_tiny.py', 'yolo3d_gac.py', settings)
    cfg = cfg_from_file(config)
    imdb_precompute_3d.run(cfg)
    testing.write_synthetic_priors(cfg.path.preprocessed_path, cfg.obj_types, num_ratios=2)
    cfg.detector.inference_dtype = 'float32'
    system = DETECTOR_DICT[cfg.detector.name](cfg.detector, device='cpu')
    val = eval_cli.dataset_of(cfg, 'validation')
    batch = val.collate_fn([val[i] for i in range(len(val))])
    images, P2 = _t(batch['images']), _t(batch['P2'])
    testing.prepare_mono_for_predict(system, images, P2, torch.Generator().manual_seed(35))
    with torch.no_grad():
        cls = system.predict_raw(images, P2)[0][..., 0].float()
        useful = system.anchors.useful_mask(system.anchor_pack(tuple(images.shape[1:3])), P2)
        system.prediction_convs()[0].bias += 1.5 - torch.quantile(cls[useful], 0.98)
    checkpoint.CheckpointManager(str(work / 'checkpoint')).save(
        0, {'model': system.net.state_dict()})
    yield config, work
    sys.modules.pop('torch.utils.tensorboard', None)


def _eval(config, work, capsys, *extra):
    eval_cli.main(['--config', config, '--checkpoint_path', str(work / 'checkpoint'),
                   '--device', 'cpu', *extra])
    return _result_files(work), _ap_table(capsys.readouterr().out)


def test_quantize_then_eval_equals_calibrating_on_the_fly(gac_tree, capsys):
    config, work = gac_tree
    artifact = str(work / 'int8.pt')
    quantize_cli.main(['--config', config, '--checkpoint_path', str(work / 'checkpoint'),
                       '--output_path', artifact, '--device', 'cpu'])
    saved = checkpoint.load_params(artifact)
    assert len(tq.flatten_quant({tuple(p.split('/')): e for p, e in saved['quant'].items()})) >= 10
    capsys.readouterr()
    from_artifact, table = _eval(config, work, capsys, '--quantized_path', artifact)
    on_the_fly, _ = _eval(config, work, capsys)
    assert from_artifact == on_the_fly and table
    assert sum(text.count(b'\n') for text in on_the_fly.values()) >= 1


def test_int8_ap_within_0_2_of_f32(gac_tree, capsys):
    config, work = gac_tree
    _, table_q = _eval(config, work, capsys)
    settings = str(config) + '.json'
    import json
    with open(settings) as f:
        values = json.load(f)
    with open(settings, 'w') as f:
        json.dump(dict(values, **{'detector.inference_dtype': 'float32'}), f)
    try:
        files_f, table_f = _eval(config, work, capsys)
    finally:
        with open(settings, 'w') as f:
            json.dump(values, f)
    assert sum(text.count(b'\n') for text in files_f.values()) >= 1
    assert sorted(table_q) == sorted(table_f) and table_f
    for key, ap_f in table_f.items():
        np.testing.assert_allclose(table_q[key], ap_f, atol=0.2, err_msg=str(key))
