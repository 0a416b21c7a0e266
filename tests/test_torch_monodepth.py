"""The ported MonoDepth slice against the JAX package, on the CPU.

* The loss helpers (``gradient_x`` / ``gradient_y``, ``smooth_loss``,
  ``reshape_depth``, ``si_log_loss``) at 1e-6, and the images' resize to
  the stride-8 and stride-4 outputs (``jax.image.resize`` shrinks with an
  antialiasing triangle kernel: ``F.interpolate(antialias=True)``).
* The whole detector at ``tests/test_retinanet_monodepth.py``'s size
  (ResNet-18, 64x128, batch 2), weights carried across by the bridge:
  ``UNetCore``'s three f32 outputs within 1e-4 of their largest value
  (JAX's DCN as its own tests run it on the CPU), the depth ``predict``;
  the bf16 outputs within max(3e-2, 1.5x JAX's own bf16-to-f32 distance);
  the dtype each conv, BatchNorm, DCN and ``LookGround`` computes in under
  bf16 inference (the decoder in f32 after ``LookGround``: every DCN on
  the f32 kernel) and under the mixed-precision policy (bf16: every DCN on
  the bf16 kernel); the loss (also with ``minor_weight`` 0.5) and one f32
  step of ``entry.build_monodepth_trainer``'s trainer against
  ``jax.value_and_grad`` + optax.
* The depth data path on a synthetic tree (``testing.write_synthetic_kitti_depth``):
  the training and validation datasets' items against JAX's (images and
  ground truth exact, P2 and K at 1e-6), ``depth_precompute``'s two files
  equal, and ``evaluate_kitti_depth``'s PNGs equal to JAX's (its
  ``cv2.resize`` of the 16-bit depth reproduced bit for bit by
  ``data/cv_ops.resize``) with its metrics within 1e-4; ``cv_ops.resize``
  of uint16 maps against ``cv2.resize`` at the three decoder map sizes.
* The DCN plans at MonoDepth's three full-width shapes.

Weights: the port's, seeded (``testing.prepare_monodepth``: batch
statistics, DCN offsets of 1 px, ``LookGround`` alpha 0.5), copied into a
flax tree by ``test_torch_gac.flax_from_port``. The JAX side hands the DCN
block a ``jnp`` P2 (inside ``jit``): with a numpy P2 the JAX
``DoubleConv`` would skip the division by the stride.
"""
import copy
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from visualdet3d_tpu.cli import depth_precompute as jax_depth_precompute
from visualdet3d_tpu.config import EasyDict as JaxEasyDict
from visualdet3d_tpu.models.detectors.yolo3d import cast_floating
from visualdet3d_tpu.models.heads import monodepth_loss as jax_loss
from visualdet3d_tpu.pipelines import evaluators as jax_evaluators
from visualdet3d_tpu.pipelines.train_state import _mp_scope
from visualdet3d_tpu.registry import DATASET_DICT as JAX_DATASETS
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
from visualdet3d_tpu.solver.optimizers import build_optimizer as jax_build_optimizer
import visualdet3d_tpu.data  # noqa: F401
import visualdet3d_tpu.models.detectors.monodepth  # noqa: F401
import visualdet3d_tpu.pipelines  # noqa: F401
from visualdet3d_tpu_torch import convert, entry, testing
from visualdet3d_tpu_torch.cli import depth_precompute
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.data import cv_ops, image_io
from visualdet3d_tpu_torch.models.detectors import monodepth
from visualdet3d_tpu_torch.models.heads import monodepth_loss
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.pipelines import evaluators, testers  # noqa: F401
from visualdet3d_tpu_torch.pipelines.train_state import mixed_precision_apply
from visualdet3d_tpu_torch.registry import DATASET_DICT, DETECTOR_DICT
import visualdet3d_tpu_torch.data  # noqa: F401
import visualdet3d_tpu_torch.models  # noqa: F401

from test_torch_gac import _jax_dtypes, _port_dtypes, _to_dict, flax_from_port

IMAGE_HW = (64, 128)
BATCH = 2
# MonoDepth's decoder DCNs at configs/monodepth.py's full width (batch 8,
# 352x1216): (name, H, W, C_in, C_out)
FULL_DCNS = (('up0', 22, 76, 768, 256), ('up1', 44, 152, 384, 64), ('up2', 88, 304, 64, 64))
DCN_PATHS = tuple(f'{n}.DoubleConv_0.ModulatedDeformConv_0' for n, *_ in FULL_DCNS)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (the tier-1 run
    puts six workers on one machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref, rel, what=''):
    """max|out - ref| <= rel * max|ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0, what
    assert np.abs(out - ref).max() <= rel * scale, (what, np.abs(out - ref).max(), scale)


# --------------------------------------------------------------------------
# the loss helpers
# --------------------------------------------------------------------------

def _sparse_depth(rng, shape, share=0.02):
    """Returns at ``share`` of the pixels, a tenth of them below 0.1 m."""
    d = np.where(rng.random(shape) < 0.1, 0.07, rng.uniform(0.5, 70.0, shape))
    return np.where(rng.random(shape) < share, d, 0.0).astype(np.float32)


def test_loss_helpers_match_jax():
    """The forward differences, the smoothness, the inverse-depth max-pool
    (windows of 8x8 and 4x4, cells without a return, returns below 0.1 m)
    and the SI-log loss (in range, past ``max_depth``, below the 1e-3 dead
    zone) within 1e-6."""
    rng = np.random.default_rng(0)
    depth = rng.standard_normal((2, 16, 32, 1)).astype(np.float32)
    image = rng.standard_normal((2, 16, 32, 3)).astype(np.float32)
    for port_fn, jax_fn in ((monodepth_loss.gradient_x, jax_loss.gradient_x),
                            (monodepth_loss.gradient_y, jax_loss.gradient_y)):
        np.testing.assert_allclose(port_fn(_t(image)).numpy(), np.asarray(jax.jit(jax_fn)(image)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(monodepth_loss.smooth_loss(_t(depth), _t(image))),
                               float(jax.jit(jax_loss.smooth_loss)(depth, image)), rtol=1e-6)
    gts = _sparse_depth(rng, (2, 64, 128))
    si_log = jax.jit(jax_loss.si_log_loss, static_argnums=(2, 3))
    for shape in ((8, 16), (16, 32), (64, 128)):
        out = monodepth_loss.reshape_depth(_t(gts), shape).numpy()
        ref = np.asarray(jax.jit(jax_loss.reshape_depth, static_argnums=1)(gts, shape))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
        assert (ref == 0).any() and (ref > 0).any()
        pred = np.exp(rng.standard_normal(ref.shape).astype(np.float32) + 2.5)
        pred = np.where(rng.random(ref.shape) < 0.2, np.maximum(ref, 0.2), pred).astype(np.float32)
        np.testing.assert_allclose(
            float(monodepth_loss.si_log_loss(_t(pred), _t(ref), 50.0, 0.3)),
            float(si_log(pred, ref, 50.0, 0.3)), rtol=1e-6)


@pytest.mark.parametrize('hw', [(8, 16), (16, 32), (13, 20)])
def test_image_resize_matches_jax(hw):
    """The images brought to the stride-8 and stride-4 outputs (and an
    uneven factor): ``jax.image.resize(..., 'bilinear')``, antialiased when
    shrinking, within 1e-5."""
    images = np.random.default_rng(1).standard_normal((2, 64, 128, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(images, (2, *hw, 3), 'bilinear'))
    np.testing.assert_allclose(monodepth.resize_images(_t(images), hw).numpy(), ref, rtol=0,
                               atol=1e-5)
    same = _t(images)
    assert monodepth.resize_images(same, (64, 128)) is same


# --------------------------------------------------------------------------
# the detector
# --------------------------------------------------------------------------

def _cfg(minor_weight=0.0):
    cfg = testing.monodepth_detector_cfg('/nonexistent', depth=18)
    cfg.minor_weight = minor_weight
    return cfg


def _P2(batch):
    """The KITTI P2 scaled to 128 columns (horizon at row ~7)."""
    return np.tile(testing._kitti_P2(IMAGE_HW[1]), (batch, 1, 1)).astype(np.float32)


def _flipped(batch):
    return {k: v[::-1].copy() for k, v in batch.items()}


@pytest.fixture(scope='module')
def pair():
    cfg = _cfg()
    jsys = JAX_DETECTORS['MonoDepth'](JaxEasyDict(copy.deepcopy(dict(cfg))))
    tsys = DETECTOR_DICT['MonoDepth'](copy.deepcopy(cfg), device='cpu')
    rng = np.random.default_rng(2)
    batch = testing.depth_training_batch(rng, BATCH, IMAGE_HW, share=0.1)
    images, P2 = batch['images'], batch['P2']
    testing.prepare_monodepth(tsys, _t(images), _t(P2), torch.Generator().manual_seed(3),
                              offset_std=1.0)
    shapes = jax.eval_shape(lambda k: jsys.init(k, IMAGE_HW, batch_size=BATCH),
                            jax.random.PRNGKey(0))
    variables = flax_from_port(shapes, tsys.net)
    assert tsys.load_flax_variables(variables) == []

    apply = jax.jit(lambda v, im, p: jsys.net.apply(v, im, p, train=False))
    j_raw, j_pred = jax.jit(lambda v, im, p: (jsys.net.apply(v, im, p, train=False),
                                              jsys.predict(v, im, p)))(
        variables, images, jnp.asarray(P2))
    dc.reset_launch_counts()
    t_raw = tsys.predict_raw(_t(images), _t(P2))
    t_pred = tsys.predict(_t(images), _t(P2))
    # bf16 inference: a bf16 copy of the weights, bf16 images, P2 f32
    v16 = cast_floating(variables, jnp.bfloat16)
    j16 = apply(v16, images.astype(jnp.bfloat16), jnp.asarray(P2))
    j16_dtypes = _jax_dtypes(lambda v, im, p: jsys.net.apply(v, im, p, train=False),
                             v16, images.astype(jnp.bfloat16), jnp.asarray(P2))
    tsys.cfg.inference_dtype = 'bfloat16'
    t16 = tsys.predict_raw(_t(images), _t(P2))
    t16_dtypes = _port_dtypes(tsys.inference_net(), lambda: tsys.predict_raw(_t(images), _t(P2)))
    tsys.cfg.inference_dtype = 'float32'

    def jax_loss_fn(policy):
        mp_ctx, mp_cast = _mp_scope('bfloat16' if policy else None)

        def loss_fn(params, b, minor_weight=0.0):
            jsys.minor_weight = minor_weight  # traced under jit: one program for both weights
            with mp_ctx():
                (loss, _), new_state = jsys.loss(
                    {'params': mp_cast(params), 'batch_stats': variables['batch_stats']},
                    b['images'], jnp.asarray(b['P2']), b['gts'], train=True)
            return loss, new_state['batch_stats']
        return loss_fn
    policy_dtypes = (_jax_dtypes(jax_loss_fn(True), variables['params'], batch),
                     _port_dtypes(tsys.net, lambda: tsys.loss(
                         _t(images), _t(P2), _t(batch['gts']),
                         apply_fn=mixed_precision_apply('bfloat16'))))
    tsys.net.load_state_dict(convert.flax_to_state_dict(variables)[0])  # undo the stats update
    grad_fn = jax.jit(jax.value_and_grad(jax_loss_fn(False), has_aux=True))
    (j_loss, j_stats), j_grads = grad_fn(variables['params'], batch, 0.0)
    _, j_grads_flipped = grad_fn(variables['params'], _flipped(batch), 0.0)
    j_minor = float(grad_fn(variables['params'], batch, 0.5)[0][0])
    tsys.minor_weight = 0.5
    t_minor = float(tsys.loss(_t(images), _t(P2), _t(batch['gts']))[0].detach())
    tsys.minor_weight = 0.0
    tsys.net.load_state_dict(convert.flax_to_state_dict(variables)[0])
    train_cfg = testing.monodepth_train_cfg(
        math.ceil(entry.KITTI_DEPTH_TRAIN_FRAMES / BATCH))
    tx = jax_build_optimizer(train_cfg.optimizer, train_cfg.scheduler, train_cfg.steps_per_epoch)
    j_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, variables['params'])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(entry, 'build_monodepth_system', lambda device=None: tsys)
        _, state, step = entry.build_monodepth_trainer(device='cpu', batch_size=BATCH)
    grads, update = {}, state.optimizer.step

    def recording_update():  # the gradients before the update clips them in place
        grads.update({n: p.grad.clone() for n, p in tsys.net.named_parameters()})
        update()
    state.optimizer.step = recording_update
    metrics = {k: float(v) for k, v in step({k: _t(v) for k, v in batch.items()}).items()}

    def bridged(tree, collection='params'):
        return convert.flax_to_state_dict({collection: _to_dict(tree)})[0]
    return dict(
        tsys=tsys, raw=(j_raw, t_raw), pred=(j_pred, t_pred), j16=(j_raw, j16), t16=t16,
        launches=dict(dc.LAUNCHES), dtypes16=(j16_dtypes, t16_dtypes),
        policy_dtypes=policy_dtypes, minor=(j_minor, t_minor), state=state, grads=grads,
        metrics=metrics, lr=train_cfg.optimizer.keywords.lr,
        jax=dict(loss=float(j_loss), grads=bridged(j_grads), grads_flipped=bridged(j_grads_flipped),
                 params=bridged(j_params), stats=bridged(j_stats, 'batch_stats')))


def test_unet_outputs_match_jax(pair):
    """The three f32 maps within 1e-4 of their largest value (the DCNs
    interpolate: offsets of 1 px; ``LookGround`` at alpha 0.5), and the
    depth ``exp(prior + scale_1)`` [B, H, W, 1] positive, within 1e-4
    relative."""
    j_raw, t_raw = pair['raw']
    assert sorted(t_raw) == sorted(j_raw) == ['scale_1', 'scale_4', 'scale_8']
    for key in j_raw:
        assert t_raw[key].shape == j_raw[key].shape, key
        _close(t_raw[key].numpy(), j_raw[key], 1e-4, key)
    j_pred, t_pred = pair['pred']
    assert t_pred['target'].shape == (BATCH, *IMAGE_HW, 1)
    assert float(t_pred['target'].min()) > 0
    np.testing.assert_allclose(t_pred['target'].numpy(), np.asarray(j_pred['target']), rtol=1e-4)
    assert set(pair['launches'].values()) == {0}  # CPU: the plain versions


def test_bf16_outputs_match_jax(pair):
    """Each map of the bf16 predict within max(3e-2, 1.5x JAX's own
    bf16-to-f32 distance) of JAX's bf16 map, norm-wise; f32 on both sides
    (the decoder runs in f32 after ``LookGround``)."""
    (j32, j16), t16 = pair['j16'], pair['t16']
    for key in j16:
        assert j16[key].dtype == jnp.float32 and t16[key].dtype == torch.float32, key
        ref16, ref32 = np.asarray(j16[key], np.float32), np.asarray(j32[key], np.float32)
        own = np.linalg.norm(ref16 - ref32) / np.linalg.norm(ref32)
        err = np.linalg.norm(t16[key].numpy() - ref16) / np.linalg.norm(ref16)
        assert err <= max(3e-2, 1.5 * own), (key, err, own)


def test_bf16_inference_dtypes_match_jax(pair):
    """Under bf16 inference every module computes in JAX's dtype: the trunk
    and ``up0``'s disparity conv in bf16, ``up0``'s ``LookGround`` returns
    f32 (P2 stays f32) and every later conv, BatchNorm and DCN is f32, so
    the three DCNs take the f32 forward kernel (K5), none the bf16 one."""
    ref, out = pair['dtypes16']
    assert out == ref
    assert ref['up0.DoubleConv_0.LookGround_0'] == 'float32'
    assert ref['up0.DoubleConv_0.LookGround_0.Conv_0'] == 'bfloat16'
    assert [ref[p] for p in DCN_PATHS] == ['float32'] * 3
    assert {v for k, v in ref.items() if k.startswith('ResNet_0')} == {'bfloat16'}


def test_policy_dtypes_match_jax(pair):
    """Under the mixed-precision policy every conv, BatchNorm, DCN and
    ``LookGround`` computes in bf16 on both sides: the three DCNs take the
    bf16 forward kernel (K3) and the bf16 backward."""
    ref, out = pair['policy_dtypes']
    assert out == ref and set(ref.values()) == {'bfloat16'}
    assert all(p in ref for p in DCN_PATHS)


def test_loss_matches_jax(pair):
    """The f32 loss of the step within rtol 1e-4, and with ``minor_weight``
    0.5 (the stride-8 and stride-4 terms against the resized images)."""
    np.testing.assert_allclose(pair['metrics']['total'], pair['jax']['loss'], rtol=1e-4)
    np.testing.assert_allclose(pair['metrics']['total_loss'], pair['jax']['loss'], rtol=1e-4)
    j_minor, t_minor = pair['minor']
    assert abs(j_minor - pair['jax']['loss']) > 1e-3 * abs(j_minor)
    np.testing.assert_allclose(t_minor, j_minor, rtol=1e-4)


def _flat(grads):
    return torch.cat([grads[n].double().ravel() for n in sorted(grads)])


def test_train_step_gradients_match_jax(pair):
    """Self-calibrated, as ``tests/test_torch_gac.py``: the floor is the
    JAX gradient of the reversed batch. The largest elementwise difference
    at most 8x the floor's (and 5e-2 of the largest gradient), the
    norm-wise difference at most 3x the floor's; each DCN's weight and
    offset conv, ``LookGround``'s disparity conv and alpha, and the trunk
    get gradients within 4x their own floor."""
    grads = pair['grads']
    ref, flipped = pair['jax']['grads'], pair['jax']['grads_flipped']
    assert sorted(ref) == sorted(grads)
    port_abs = max(float((grads[n] - g).abs().max()) for n, g in ref.items())
    floor_abs = max(float((flipped[n] - g).abs().max()) for n, g in ref.items())
    gmax = max(float(g.abs().max()) for g in ref.values())
    assert port_abs <= max(8 * floor_abs, 1e-5 * gmax), (port_abs, floor_abs, gmax)
    assert port_abs <= 5e-2 * gmax, (port_abs, gmax)
    den = float(_flat(ref).norm())
    port = float((_flat(grads) - _flat(ref)).norm()) / den
    floor = float((_flat(flipped) - _flat(ref)).norm()) / den
    assert port <= max(3 * floor, 1e-5), (port, floor)
    leaves = ['ResNet_0.layer1_0.Conv_0.weight']
    for p in DCN_PATHS:
        leaves += [f'{p}.weight', f'{p}.Conv_0.weight']
    for n in ('up0', 'up1'):
        leaves += [f'{n}.DoubleConv_0.LookGround_0.Conv_0.weight',
                   f'{n}.DoubleConv_0.LookGround_0.alpha']
    for name in leaves:
        assert float(grads[name].abs().max()) > 0, name
        rel = float((grads[name] - ref[name]).norm() / ref[name].norm())
        rel_floor = float((flipped[name] - ref[name]).norm() / ref[name].norm())
        assert rel <= max(4 * rel_floor, 1e-4), (name, rel, rel_floor)


def test_train_step_batch_stats_and_params_match_jax(pair):
    """The running statistics after the step within 1e-4 of their largest
    value; the parameters after the clipped Adam step within 2.5 * lr; one
    update, and the network back in eval mode."""
    tsys, ref = pair['tsys'], pair['jax']
    buffers = dict(tsys.net.named_buffers())
    for name, value in ref['stats'].items():
        if not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(buffers[name].numpy(), value.numpy(), rtol=0,
                                       atol=1e-4 * float(value.abs().max()), err_msg=name)
    lr = pair['state'].optimizer.schedule(0)
    assert lr == pytest.approx(pair['lr'])
    params = dict(tsys.net.named_parameters())
    worst = max(float((params[n].detach() - v).abs().max()) for n, v in ref['params'].items())
    assert worst <= 2.5 * lr, (worst, lr)
    assert pair['state'].step == 1 and pair['state'].optimizer.count == 1
    assert not tsys.net.training


def test_bn_fold_keeps_the_depth():
    """``fold_inference_variables`` folds the trunk's and the decoder's 5x5
    conv + BN pairs (the DCNs' BatchNorms stay: a DCN is no conv to fold
    into). The network, evaluated in f64 before and after, gives the three
    maps within 1e-4 of their largest value: the fold's only error is its
    weights' rounding to f32, which this random, batch-calibrated network
    amplifies to 1.5-2.4e-5 (its own f32 forward sits 1-2.5e-4 from f64);
    a wrong fold would move them by their whole size."""
    tsys = DETECTOR_DICT['MonoDepth'](_cfg(), device='cpu')
    rng = np.random.default_rng(8)
    images = _t(rng.standard_normal((1, *IMAGE_HW, 3)).astype(np.float32))
    P2 = _t(_P2(1))
    testing.prepare_monodepth(tsys, images, P2, torch.Generator().manual_seed(9))

    def f64_maps():
        tsys.net.double()
        with torch.no_grad():
            out = tsys.net(images.double().permute(0, 3, 1, 2), P2.double())
        tsys.net.float()
        return out
    before = f64_maps()
    pairs = tsys.fold_inference_variables(IMAGE_HW)
    assert sorted(b[-1] for _, b in pairs if b[0].startswith('up')) == ['BatchNorm_0'] * 3
    for key, out in f64_maps().items():
        _close(out.numpy(), before[key].numpy(), 1e-4, key)


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    """Without CUDA the default device raises; the configs are
    ``configs/monodepth.py``'s; int8 is refused until its slice."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for fn in (entry.build_monodepth_system, entry.build_monodepth_trainer):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            fn()
    cfg = testing.monodepth_detector_cfg()
    assert cfg.backbone.depth == 34 and cfg.backbone.out_indices == (0, 1, 2, 3)
    train = testing.monodepth_train_cfg()
    assert train.optimizer.clipped_gradient_norm == 0.1
    assert train.scheduler.type_name == 'ExponentialLR' and train.scheduler.keywords.gamma == 0.98
    tsys = DETECTOR_DICT['MonoDepth'](_cfg(), device='cpu')
    assert tsys.prior_mean == pytest.approx(math.log(15.0))
    tsys.cfg.inference_dtype = 'int8'
    with pytest.raises(NotImplementedError, match='JAX package has no calibrate_int8'):
        tsys.predict(np.zeros((1, *IMAGE_HW, 3), np.float32), _P2(1))


# --------------------------------------------------------------------------
# the DCN plans at the full width
# --------------------------------------------------------------------------

@pytest.mark.parametrize('name,h,w,c_in,c_out', FULL_DCNS)
def test_dcn_plans_take_the_full_width_shapes(name, h, w, c_in, c_out):
    """At batch 8 and 352x1216: the f32 dx kernel keeps its 64-pixel tile
    with dy resident in shared memory; the bf16 dx tile covers the map; dW
    splits into whole waves of an H100's 132 SMs over non-empty runs of
    stages; the forward variants as the JAX gates pick them (all-taps
    reaches every shape in bf16 under its switch; premul only bf16
    inference, which MonoDepth's decoder never runs: it is f32 there)."""
    tile, resident, smem = dc.dx_f32_plan(c_out)
    assert (tile, resident) == (64, True) and smem <= dc.SMEM_LIMIT
    th, tw = dc.dx_plan(h, w)
    assert (th, tw) in dc.DX_TILES
    for dtype in (torch.float32, torch.bfloat16):
        chunks = dc.dw_stages(8, h, w, dtype)
        splits = dc.dw_plan(chunks, c_in, c_out, 9, 132)
        per = -(-chunks // splits)
        assert 1 <= splits <= chunks and -(-chunks // per) == splits
        tiles = dc.dw_tiles(c_in, c_out)
        cost = -(-tiles * splits // 132) * (per + dc.DW_TILE_OVERHEAD)
        assert cost <= -(-tiles // 132) * (chunks + dc.DW_TILE_OVERHEAD)  # never worse than one split
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VD3D_DCN_ALLTAPS', '1')
        mp.setenv('VD3D_DCN_PREMUL', '1')
        assert dc.forward_variant(h * w, c_in, c_out, torch.bfloat16, train=True) == 'alltaps'
        assert dc.forward_variant(h * w, c_in, c_out, torch.float32) == 'per_tap'
        want = 'premul' if c_out < c_in else 'alltaps'
        assert dc.forward_variant(h * w, c_in, c_out, torch.bfloat16) == want


# --------------------------------------------------------------------------
# the depth data path and the evaluation
# --------------------------------------------------------------------------

TREE_HW = (64, 160)
MEAN, STD = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])


def _depth_cfg(tree, out, easydict):
    """The depth datasets' config at 48x112 (``tests/test_depth_dataset.py``'s
    shape of ``configs/monodepth.py``; no photometric distortion)."""
    cfg = easydict()
    cfg.obj_types = []
    cfg.path = easydict(raw_path=tree['raw_path'], depth_path=tree['depth_path'],
                        validation_path=tree['validation_path'], preprocessed_path=out)
    cfg.data = easydict(rgb_shape=(48, 112, 3), train_dataset='KittiDepthMonoDataset',
                        val_dataset='KittiDepthMonoValTestDataset', num_workers=0, batch_size=2)
    norm = easydict(type_name='Normalize', keywords=easydict(mean=MEAN, stds=STD))
    cfg.data.test_augmentation = [
        easydict(type_name='ConvertToFloat'),
        easydict(type_name='CropTop', keywords=easydict(output_height=48)),
        easydict(type_name='CropRight', keywords=easydict(output_width=112)), norm]
    cfg.data.train_augmentation = [
        easydict(type_name='ConvertToFloat'),
        easydict(type_name='CropTop', keywords=easydict(output_height=48)),
        easydict(type_name='RandomCropToWidth', keywords=easydict(width=112)),
        easydict(type_name='RandomMirror', keywords=easydict(mirror_prob=0.5)), norm]
    cfg.trainer = easydict(test_func='test_mono_depth')
    return cfg


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return testing.write_synthetic_kitti_depth(str(tmp_path_factory.mktemp('depth')), 4,
                                               seed=4, n_val=2, image_hw=TREE_HW)


def _same_item(ours, ref):
    assert sorted(ours) == sorted(ref)
    np.testing.assert_array_equal(ours['image'], ref['image'])
    if 'gt' in ref:
        np.testing.assert_array_equal(ours['gt'], ref['gt'])
    np.testing.assert_allclose(ours['P'], ref['P'], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours['K'], ref['K'], rtol=1e-6, atol=1e-6)
    assert tuple(ours['original_shape']) == tuple(ref['original_shape'])


@pytest.mark.parametrize('split', ['training', 'val'])
def test_depth_dataset_matches_jax(tree, tmp_path, split):
    """Both eyes, the random crop and the mirror under the same numpy
    draws (training), the evaluation transform ('val', as the precompute
    reads it): every item's image and ground truth exactly JAX's, P and K
    at 1e-6; the collated batch too."""
    ours = DATASET_DICT['KittiDepthMonoDataset'](_depth_cfg(tree, str(tmp_path), EasyDict), split)
    ref = JAX_DATASETS['KittiDepthMonoDataset'](_depth_cfg(tree, str(tmp_path), JaxEasyDict),
                                                split)
    assert len(ours) == len(ref) == 4
    state = np.random.get_state()
    try:
        for i in range(len(ref)):
            np.random.seed(10 + i)
            r = ref[i]
            np.random.seed(10 + i)
            _same_item(ours[i], r)
    finally:
        np.random.set_state(state)
    np.random.seed(0)
    a = ours.collate_fn([ours[0], ours[1]])
    np.random.seed(0)
    b = ref.collate_fn([ref[0], ref[1]])
    for key in ('images', 'P2', 'gts'):
        np.testing.assert_array_equal(a[key], b[key])


def test_depth_val_dataset_matches_jax(tree, tmp_path):
    ours = DATASET_DICT['KittiDepthMonoValTestDataset'](
        _depth_cfg(tree, str(tmp_path), EasyDict), 'validation')
    ref = JAX_DATASETS['KittiDepthMonoValTestDataset'](
        _depth_cfg(tree, str(tmp_path), JaxEasyDict), 'validation')
    assert len(ours) == len(ref) == 2
    for i in range(2):
        _same_item(ours[i], ref[i])


def test_depth_precompute_matches_jax(tree, tmp_path):
    """``python -m visualdet3d_tpu_torch.cli.depth_precompute``'s two files
    equal to the JAX CLI's."""
    outs = {}
    for side in ('port', 'jax'):
        out = tmp_path / side
        config = tmp_path / f'{side}_cfg.py'
        config.write_text(
            'import sys\n'
            f'sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n'
            'from visualdet3d_tpu.config import EasyDict as edict\n'
            'from test_torch_monodepth import _depth_cfg\n'
            f'cfg = _depth_cfg({tree!r}, {str(out)!r}, edict)\n')
        if side == 'port':
            depth_precompute.main(['--config', str(config)])
        else:
            jax_depth_precompute.precompute_depth_statistic(str(config))
        outs[side] = [np.load(out / 'training' / f) for f in
                      ('log_depth_sum.npy', 'log_depth_solid.npy')]
    for a, b in zip(outs['port'], outs['jax']):
        assert a.dtype == b.dtype and a.shape == (48, 112)
        np.testing.assert_array_equal(a, b)
    prior = monodepth.prior_mean_of(str(tmp_path / 'port'))
    assert 0.0 < prior < np.log(80)


def _fake_depth(images):
    """A deterministic depth map [B, H, W] (0.3-80 m) of the images."""
    x = images.astype(np.float32).mean(axis=-1)
    return (0.3 + 80.0 / (1.0 + np.exp(-x))).astype(np.float32)


class _PortDepth:
    def predict(self, images, P2):
        return {'target': torch.from_numpy(_fake_depth(np.asarray(images))[..., None])}


class _JaxDepth:
    def predict(self, variables, images, P2):
        return {'target': _fake_depth(np.asarray(images))[..., None]}


def test_evaluate_kitti_depth_matches_jax(tmp_path):
    """At KITTI's 375x1242 (cropped to 352x1216 and restored: the pad of 23
    rows and the 16-bit resize to 1242 columns) the PNGs decode to JAX's
    (``cv2.resize`` / ``cv2.imwrite``) bit for bit, and the metrics agree
    within 1e-4 relative."""
    tree = testing.write_synthetic_kitti_depth(str(tmp_path / 'tree'), 0, seed=5, n_val=2)
    texts, files = {}, {}
    for side, easydict, evaluate, system in (
            ('port', EasyDict, evaluators.evaluate_kitti_depth, _PortDepth()),
            ('jax', JaxEasyDict, jax_evaluators.evaluate_kitti_depth, _JaxDepth())):
        cfg = _depth_cfg(tree, str(tmp_path / side), easydict)
        cfg.data.test_augmentation[1].keywords.output_height = 352
        cfg.data.test_augmentation[2].keywords.output_width = 1216
        dataset = (DATASET_DICT if side == 'port' else JAX_DATASETS)[
            'KittiDepthMonoValTestDataset'](cfg, 'validation')
        args = (cfg, system) if side == 'port' else (cfg, system, None)
        texts[side] = evaluate(*args, dataset, None, 0)
        result = tmp_path / side / 'validation' / 'data'
        files[side] = sorted(os.listdir(result))
        files[side] = [image_io.read_png(str(result / f)) if side == 'port'
                       else cv2.imread(str(result / f), -1) for f in files[side]]
    assert len(files['port']) == len(files['jax']) == 2
    for a, b in zip(files['port'], files['jax']):
        assert a.dtype == b.dtype == np.uint16 and a.shape == (375, 1242)
        np.testing.assert_array_equal(a, b)
    values = {k: [float(t.split(':')[1]) for t in v] for k, v in texts.items()}
    assert [t.split(':')[0] for t in texts['port']] == [t.split(':')[0] for t in texts['jax']]
    np.testing.assert_allclose(values['port'], values['jax'], rtol=1e-4)


@pytest.mark.parametrize('hw', [(22, 76), (88, 304), (352, 1216)])
def test_uint16_resize_matches_cv2(hw):
    """``cv_ops.resize`` of a uint16 map to 1242x375 equal to
    ``cv2.resize`` at every pixel (random values over the whole 16-bit
    range, and a smooth depth map x 256)."""
    rng = np.random.default_rng(hw[0])
    noise = rng.integers(0, 65536, hw).astype(np.uint16)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    smooth = ((5.0 + 40.0 * yy / hw[0] + np.sin(xx / 7.0)) * 256).astype(np.uint16)
    for image in (noise, smooth):
        np.testing.assert_array_equal(cv_ops.resize(image, (1242, 375)),
                                      cv2.resize(image, (1242, 375)))
