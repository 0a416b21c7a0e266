"""The ported YOLOStereo3D training slice against the JAX package, on the CPU.

Module by module (the detection and disparity losses and their gradients,
the target encode, the anchor assignment, the detection loss, the flax-style
3-D BatchNorm, the pyramid's train-only disparity head, the class tower's
dropout, the skip rule, remat), then one whole f32 training step of
YOLOStereo3D (``tiny_stereo_cfg``: ResNet-18 at 64x160, batch 2) against
``jax.value_and_grad`` of the JAX system's loss and an optax update, and one
bf16 mixed-precision step against the JAX package's own bf16 step, each
with ``norm_eval`` False (the tiny config) and True (the benchmark config's
trunk). Inputs come from numpy seeds; the JAX side runs jitted, each JAX
gradient once per setting (fixtures).

Weights of the whole-step tests: the JAX package's train-mode init, its two
zero-initialised prediction convs given small seeded normal weights (so
that the detection loss reaches the whole network), loaded through the
weight bridge, the disparity head included. The class tower's dropout
cannot draw JAX's random bits: it is off on both sides for the parity
tests (an ``nn.intercept_methods`` hook on the JAX side, ``system.dropout``
on the port's); its masks are tested on their own.

Tolerances (each with its reason at the assertion): exact for the
assignment, the one-hot and ignore masks and the bridge; the losses' values
within rtol 1e-5 and their gradients within 1e-5 of each gradient's largest
value (XLA and torch evaluate exp, log and sigmoid with their own code);
the encode within 2 f32 ulps (sin, cos and log likewise); the detection
loss within rtol 2e-4; BatchNorm and the disparity head within 1e-5 of
their largest value (conv summation order); the whole step's loss terms
within rtol 2e-4 and its gradients self-calibrated against the JAX
gradients of the reversed batch; batch statistics within 1e-4 of their
largest value; parameters after the Adam step within 2.5 * lr; the bf16
step within limits set by the JAX package's own bf16-to-f32 shift on the
same fixture.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as flax_nn

from visualdet3d_tpu.models.detectors.yolostereo3d import CostVolumePyramid as JaxPyramid
from visualdet3d_tpu.models.heads import detection_3d_head as jax_head
from visualdet3d_tpu.models.heads import losses as jax_losses
from visualdet3d_tpu.models.heads import target_coding as jax_coding
from visualdet3d_tpu.pipelines.train_state import _mp_scope
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
from visualdet3d_tpu.solver.optimizers import build_optimizer as jax_build_optimizer
import visualdet3d_tpu.models.detectors.yolostereo3d  # noqa: F401
from visualdet3d_tpu_torch import convert, testing
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.models.backbones.resnet import ResNet
from visualdet3d_tpu_torch.models.blocks import BatchNorm3d, ChannelDropout
from visualdet3d_tpu_torch.models.detectors.yolostereo3d import CostVolumePyramid
from visualdet3d_tpu_torch.models.heads import detection_3d_head, losses, target_coding
from visualdet3d_tpu_torch.ops import cost_volume as cv
from visualdet3d_tpu_torch.pipelines import trainers  # noqa: F401
from visualdet3d_tpu_torch.pipelines.train_state import TrainState
from visualdet3d_tpu_torch.registry import DETECTOR_DICT, PIPELINE_DICT
from visualdet3d_tpu_torch.solver.optimizers import build_optimizer
import visualdet3d_tpu_torch.models  # noqa: F401

from helpers import write_fake_priors
from test_stereo_system import IMAGE_HW, sample_P, tiny_stereo_cfg

BATCH = 2
STEPS_PER_EPOCH = 10


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (the tier-1 run
    puts six workers on one machine, where torch's spinning thread pool
    costs several times its work; the tensors here are small)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_dict(tree):
    if hasattr(tree, 'items'):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# the losses, values and gradients
# --------------------------------------------------------------------------

def _value_and_grad_pair(jax_fn, torch_fn, *arrays):
    """jax.value_and_grad and torch autograd of a scalar function of the
    first array (the rest are constants)."""
    ref, ref_grad = jax.jit(jax.value_and_grad(jax_fn))(*map(jnp.asarray, arrays))
    x = _t(arrays[0]).requires_grad_()
    out = torch_fn(x, *map(_t, arrays[1:]))
    out.backward()
    return (float(ref), np.asarray(ref_grad)), (float(out.detach()), x.grad.numpy())


def _check_value_and_grad(pair, what):
    (ref, ref_grad), (out, grad) = pair
    np.testing.assert_allclose(out, ref, rtol=1e-5, err_msg=what)
    assert np.abs(ref_grad).max() > 0, what
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=1e-5 * np.abs(ref_grad).max(),
                               err_msg=what)


def test_sigmoid_focal_loss_matches_jax():
    """Ignored entries (-1), negatives and positives, and confident correct
    logits whose loss falls under the 1e-5 clamp."""
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (4, 50, 2)).astype(np.float32)
    targets = rng.choice([-1.0, 0.0, 1.0], (4, 50, 2), p=[0.3, 0.5, 0.2]).astype(np.float32)
    logits[0, :10] = np.where(targets[0, :10] == 1, 14.0, -14.0)  # under the clamp
    weights = np.array([20.0, 40.0], np.float32)
    ref = np.asarray(jax_losses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                                                   2.0, jnp.asarray(weights)))
    out = losses.sigmoid_focal_loss(_t(logits), _t(targets), 2.0, _t(weights)).numpy()
    np.testing.assert_array_equal(out == 0, ref == 0)  # ignore and clamp: the same entries
    assert (ref[targets == -1] == 0).all() and ((ref == 0) & (targets != -1)).any()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    _check_value_and_grad(_value_and_grad_pair(
        lambda x, t, w: jax_losses.sigmoid_focal_loss(x, t, 2.0, w).sum(),
        lambda x, t, w: losses.sigmoid_focal_loss(x, t, 2.0, w).sum(),
        logits, targets, weights), 'focal')


def test_modified_smooth_l1_matches_jax():
    """Differences in the dead zone (<= 0.01), on the quadratic part (<=
    1/25) and on the linear part."""
    rng = np.random.default_rng(2)
    targets = rng.normal(0, 1, (3, 40, 12)).astype(np.float32)
    diff = np.concatenate([rng.uniform(-0.009, 0.009, (3, 10, 12)),
                           rng.uniform(0.012, 0.039, (3, 10, 12)),
                           rng.normal(0, 2, (3, 20, 12))], 1).astype(np.float32)
    preds = targets + diff
    ref = np.asarray(jax_losses.modified_smooth_l1(jnp.asarray(targets), jnp.asarray(preds)))
    out = losses.modified_smooth_l1(_t(targets), _t(preds)).numpy()
    assert (ref[:, :10] == 0).all() and (out[:, :10] == 0).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    _check_value_and_grad(_value_and_grad_pair(
        lambda p, t: jax_losses.modified_smooth_l1(t, p).sum(),
        lambda p, t: losses.modified_smooth_l1(t, p).sum(), preds, targets), 'smooth_l1')
    logits = rng.normal(0, 2, (3, 40, 1)).astype(np.float32)
    labels = (rng.uniform(size=(3, 40, 1)) > 0.5).astype(np.float32)
    _check_value_and_grad(_value_and_grad_pair(
        lambda x, t: jax_losses.bce_with_logits(x, t).sum(),
        lambda x, t: losses.bce_with_logits(x, t).sum(), logits, labels), 'bce')


def _disparity(rng, shape, num_disp):
    """Ground truth with invalid zeros, values past D - 1 and fractions."""
    gt = rng.uniform(0, num_disp + 4, shape).astype(np.float32)
    gt[rng.uniform(size=shape) < 0.3] = 0.0
    return gt


@pytest.mark.parametrize('name', ['laplace', 'gaussian', 'onehot'])
def test_disparity_probabilities_match_jax(name):
    rng = np.random.default_rng(3)
    gt = _disparity(rng, (2, 5, 7), 24)
    fn = f'{name}_disp_probability'
    ref_prob, ref_mask = getattr(jax_losses, fn)(jnp.asarray(gt), 24, 0.5)
    prob, mask = getattr(losses, fn)(_t(gt), 24, 0.5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert 0 < mask.float().mean() < 1
    np.testing.assert_allclose(prob.numpy(), np.asarray(ref_prob), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('sparse', [True, False], ids=['sparse', 'dense'])
def test_downscale_disparity_matches_jax(sparse):
    rng = np.random.default_rng(4)
    gt = _disparity(rng, (2, 16, 40), 96)
    ref = np.asarray(jax_losses._downscale_disparity(jnp.asarray(gt), (4, 10), sparse))
    out = losses._downscale_disparity(_t(gt), (4, 10), sparse).numpy()
    assert out.shape == (2, 4, 10)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert losses._downscale_disparity(_t(gt), (16, 40), sparse) is not None


@pytest.mark.parametrize('gt_hw', [(4, 10), (16, 40)], ids=['same_size', 'downscaled'])
def test_stereo_focal_loss_matches_jax(gt_hw):
    rng = np.random.default_rng(5)
    est = rng.normal(0, 2, (2, 4, 10, 96)).astype(np.float32)
    gt = _disparity(rng, (2, *gt_hw), 96 * gt_hw[1] // 10)
    _check_value_and_grad(_value_and_grad_pair(
        lambda e, g: jax_losses.stereo_focal_loss(e, g, variance=0.5, sparse=True),
        lambda e, g: losses.stereo_focal_loss(e, g, variance=0.5, sparse=True), est, gt),
        'stereo_focal')


# --------------------------------------------------------------------------
# target coding, assignment, the detection loss
# --------------------------------------------------------------------------

def _anchors_and_boxes(rng, image_hw=(64, 160)):
    """Anchors on a 16-pixel grid (two sizes, two ratios), and padded
    annotations: boxes near anchors, one duplicated (a tie between two
    boxes for the same anchors), padding rows (class -1)."""
    h, w = image_hw
    ys, xs = np.meshgrid(np.arange(8, h, 16), np.arange(8, w, 16), indexing='ij')
    base = [(24, 24), (32, 32), (34, 17), (17, 34)]
    anchors = np.concatenate([np.stack([xs.ravel() - bw / 2, ys.ravel() - bh / 2,
                                        xs.ravel() + bw / 2, ys.ravel() + bh / 2], 1)
                              for bw, bh in base]).astype(np.float32)
    ann = np.full((3, 6, 12), -1.0, np.float32)
    for b, n in enumerate((4, 1, 0)):  # the last image has no box
        for j in range(n):
            x1, y1 = rng.uniform(0, w - 40), rng.uniform(0, h - 30)
            bw, bh = rng.uniform(18, 40), rng.uniform(14, 30)
            ann[b, j] = [x1, y1, x1 + bw, y1 + bh, rng.integers(0, 2), x1 + bw / 2,
                         y1 + bh / 2, rng.uniform(5, 40), 1.6, 1.5, 3.9,
                         rng.uniform(-np.pi, np.pi)]
    ann[0, 3] = ann[0, 2]  # two identical boxes: the last one wins the tie
    ann[0, 3, 4] = 1 - ann[0, 2, 4]
    useful = rng.uniform(size=(3, anchors.shape[0])) > 0.1
    mean_std = np.stack([rng.uniform(-1, 30, (anchors.shape[0], 2, 6)),
                         rng.uniform(0.5, 8, (anchors.shape[0], 2, 6))], -1).astype(np.float32)
    mean_std[::7, :, 0, 0] = -1.0  # anchors without a z prior
    return anchors, ann, useful, mean_std


@pytest.mark.parametrize('match_low_quality', [True, False], ids=['low_quality', 'max_iou'])
def test_assign_anchors_matches_jax_exactly(match_low_quality):
    anchors, ann, useful, _ = _anchors_and_boxes(np.random.default_rng(6))
    ref = jax.jit(jax.vmap(lambda a, u: jax_head.assign_anchors(
        jnp.asarray(anchors), a, u, 0.5, 0.4, match_low_quality)))(jnp.asarray(ann),
                                                                    jnp.asarray(useful))
    out = detection_3d_head.assign_anchors(_t(anchors), _t(ann), _t(useful), 0.5, 0.4,
                                           match_low_quality)
    for key in ('pos_mask', 'neg_mask', 'max_iou'):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    pos = out['pos_mask'].numpy()
    np.testing.assert_array_equal(out['gt_index'].numpy()[pos], np.asarray(ref['gt_index'])[pos])
    assert pos[0].sum() > 0 and pos[2].sum() == 0
    if match_low_quality:  # the tie between the duplicated boxes goes to the last
        hit = out['gt_index'].numpy()[0][pos[0]]
        assert 3 in hit and 2 not in hit


def test_encode_matches_jax():
    """Within 2 f32 ulps of each value: XLA and torch compute log, sin and
    cos with their own code (measured: equal at most entries)."""
    rng = np.random.default_rng(7)
    anchors, ann, _, mean_std = _anchors_and_boxes(rng)
    rows = ann[0, rng.integers(0, 4, anchors.shape[0])]
    sel = mean_std[:, 0]
    ref_t, ref_a = jax.jit(jax_coding.encode)(jnp.asarray(anchors), jnp.asarray(rows),
                                              jnp.asarray(sel))
    out_t, out_a = target_coding.encode(_t(anchors), _t(rows), _t(sel))
    np.testing.assert_array_equal(out_a.numpy(), np.asarray(ref_a))
    ref_t = np.asarray(ref_t)
    np.testing.assert_allclose(out_t.numpy(), ref_t, rtol=2.4e-7, atol=1e-7)


@pytest.mark.parametrize('match_low_quality', [True, False], ids=['low_quality', 'max_iou'])
def test_detection_3d_loss_matches_jax(match_low_quality):
    """Values and gradients within rtol 2e-4 (reduction order over the
    anchors)."""
    rng = np.random.default_rng(8)
    anchors, ann, useful, mean_std = _anchors_and_boxes(rng)
    n = anchors.shape[0]
    cls = rng.normal(-1, 2, (3, n, 3)).astype(np.float32)
    reg = rng.normal(0, 1, (3, n, 12)).astype(np.float32)
    kw = dict(num_classes=2, focal_loss_gamma=2.0, balance_weights=[20.0, 40.0],
              regression_weight=[1, 1, 1, 1, 1, 1, 12, 1, 1, 0.5, 0.5, 0.5, 1],
              L1_regression_alpha=25.0, match_low_quality=match_low_quality)

    def jax_fn(c, r):
        cl, rl, _ = jax_head.detection_3d_loss(c, r, jnp.asarray(anchors), jnp.asarray(mean_std),
                                               jnp.asarray(useful), jnp.asarray(ann), **kw)
        return cl[0] + rl[0], (cl[0], rl[0])
    (ref, (ref_cls, ref_reg)), (gc, gr) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(jnp.asarray(cls), jnp.asarray(reg))
    tc, tr = _t(cls).requires_grad_(), _t(reg).requires_grad_()
    out_cls, out_reg, terms = detection_3d_head.detection_3d_loss(
        tc, tr, _t(anchors), _t(mean_std), _t(useful), _t(ann), **kw)
    (out_cls + out_reg).sum().backward()
    assert out_cls.shape == (1,) and out_reg.shape == (1,)
    assert float(ref_cls) > 0 and float(ref_reg) > 0
    np.testing.assert_allclose(float(out_cls.detach()), float(ref_cls), rtol=2e-4)
    np.testing.assert_allclose(float(out_reg.detach()), float(ref_reg), rtol=2e-4)
    np.testing.assert_allclose(float(terms['total_loss'].detach()), float(ref), rtol=2e-4)
    for g, ref_g in ((tc.grad, gc), (tr.grad, gr)):
        ref_g = np.asarray(ref_g)
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=0, atol=2e-4 * np.abs(ref_g).max())


# --------------------------------------------------------------------------
# BatchNorm3d, the disparity head, dropout
# --------------------------------------------------------------------------

def test_batchnorm3d_train_mode_follows_flax():
    """n = 2 x 3 x 2 x 5 = 60 values per channel: torch's own running
    variance (unbiased) would differ from flax's by n / (n - 1)."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 3, 2, 5, 8)) * 2 + 0.5).astype(np.float32)  # NDHWC
    scale = rng.uniform(0.5, 2, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    stats = {'mean': rng.standard_normal(8).astype(np.float32),
             'var': rng.uniform(0.5, 2, 8).astype(np.float32)}
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    ref, new = bn.apply({'params': {'scale': scale, 'bias': bias}, 'batch_stats': stats},
                        jnp.asarray(x), mutable=['batch_stats'])
    tbn = BatchNorm3d(8)
    convert.load_flax_variables(tbn, {'params': {'scale': scale, 'bias': bias},
                                      'batch_stats': stats})
    tbn.train()
    out = tbn(_t(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for name in ('mean', 'var'):
        np.testing.assert_allclose(getattr(tbn, f'running_{name}').numpy(),
                                   np.asarray(new['batch_stats'][name]), rtol=1e-6, atol=1e-6)
    # bf16 in (with bf16 scale and bias): bf16 out, f32 statistics
    y = tbn.to(torch.bfloat16).float()(_t(x).permute(0, 4, 1, 2, 3).bfloat16())
    assert y.dtype == torch.bfloat16 and tbn.running_var.dtype == torch.float32


def test_disparity_head_matches_jax():
    """The pyramid in train mode, the train-only disparity head included
    (F.interpolate against jax.image.resize): features and the disparity
    volume within 1e-5 of their largest value, and the running statistics
    of every BatchNorm after the call."""
    rng = np.random.default_rng(10)
    psv = [rng.standard_normal((2, 8 // s, 20 // s, c)).astype(np.float32)
           for s, c in ((1, 24), (2, 24), (4, 96))]
    jmod = JaxPyramid(24, 24, 96)
    variables = _to_dict(jax.jit(lambda k: jmod.init(k, *psv, train=True))(jax.random.PRNGKey(1)))
    (ref_f, ref_d), new = jax.jit(lambda v: jmod.apply(v, *psv, train=True,
                                                       mutable=['batch_stats']))(variables)
    tmod = CostVolumePyramid(24, 24, 96, disparity_head=True)
    assert convert.load_flax_variables(tmod, variables) == []
    tmod.train()
    feat, disp = tmod(*[_t(p).permute(0, 3, 1, 2) for p in psv])
    assert disp.shape == (2, 96, 8, 20)
    for out, ref in ((feat, ref_f), (disp, ref_d)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    stats = convert.flax_to_state_dict({'batch_stats': _to_dict(new['batch_stats'])})[0]
    buffers = dict(tmod.named_buffers())
    assert any(k.startswith('BatchNorm_0.') for k in stats)
    for key, value in stats.items():
        if value.is_floating_point():
            np.testing.assert_allclose(buffers[key].numpy(), value.numpy(), rtol=0,
                                       atol=1e-5 * float(value.abs().max()), err_msg=key)
    tmod.eval()
    assert tmod(*[_t(p).permute(0, 3, 1, 2) for p in psv])[1] is None  # inference: no head


def test_channel_dropout_draws_whole_channels_from_its_generator():
    x = torch.ones(8, 64, 3, 5)
    drop = ChannelDropout(0.3).train()
    assert torch.equal(drop(x), x)  # no generator: the identity (flax's deterministic)
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(x)
    kept = y[:, :, 0, 0] != 0
    assert torch.equal(y, kept[..., None, None].float().expand_as(y) / 0.7)  # whole channels
    assert 0.6 < float(kept.float().mean()) < 0.8  # 512 draws: a rate near 0.3
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x), y)  # the same mask from the same seed
    drop.generator = torch.Generator().manual_seed(4)
    assert not torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)


# --------------------------------------------------------------------------
# systems: the bridge, the skip rule, remat
# --------------------------------------------------------------------------

def _tiny_cfg(pre, norm_eval=False):
    cfg = tiny_stereo_cfg(pre)
    cfg.backbone.norm_eval = norm_eval
    return EasyDict(copy.deepcopy(cfg))


@pytest.fixture(scope='module')
def priors(tmp_path_factory):
    pre = str(tmp_path_factory.mktemp('pre'))
    write_fake_priors(pre, ['Car', 'Pedestrian'])
    return pre


def _batch(seed, batch_size=BATCH):
    """``testing.stereo_training_batch`` with the JAX stereo tests'
    calibration (``sample_P``), whose road corridor keeps many of the tiny
    config's anchors."""
    batch = testing.stereo_training_batch(np.random.default_rng(seed), batch_size, IMAGE_HW)
    return dict(batch, P2=sample_P(batch_size), P3=sample_P(batch_size, tx=-120.0))


def test_skip_rule_at_zero_loss_keeps_params_and_adam_state(priors):
    """No box and no disparity: total 0, so neither the parameters nor the
    Adam state move, while the step count advances and the running
    statistics take the batch's (the JAX step's where-mask keeps new
    batch_stats either way)."""
    tsys = DETECTOR_DICT['Stereo3D'](_tiny_cfg(priors), device='cpu', training=True)
    cfg = testing.stereo_train_cfg(STEPS_PER_EPOCH)
    state = TrainState(build_optimizer(tsys.net.parameters(), cfg.optimizer, cfg.scheduler,
                                       STEPS_PER_EPOCH))
    step = PIPELINE_DICT['train_stereo_detection'](tsys)
    batch = _batch(1)
    step(state, batch)
    assert state.optimizer.count == 1
    params = {k: v.clone() for k, v in tsys.net.named_parameters()}
    buffers = {k: v.clone() for k, v in tsys.net.named_buffers()}
    adam = {id(p): {k: torch.as_tensor(v).clone() for k, v in s.items()}
            for p, s in state.optimizer.torch_optimizer.state.items()}
    empty = dict(batch, annotations=np.full_like(batch['annotations'], -1.0))
    del empty['disparity']
    metrics = step(state, empty)
    assert float(metrics['total']) == 0.0
    assert state.step == 2 and state.optimizer.count == 1
    for k, v in tsys.net.named_parameters():
        assert torch.equal(v, params[k]), k
    for p, s in state.optimizer.torch_optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v), adam[id(p)][k]), k
    moved = [k for k, v in tsys.net.named_buffers()
             if v.is_floating_point() and not torch.equal(v, buffers[k])]
    assert any('ResNet_0' in k for k in moved) and any('StereoHead_0' in k for k in moved)
    assert not tsys.net.training


def test_remat_same_params_outputs_grads_and_running_stats():
    """remat recomputes each block in the backward; the recompute must not
    update the running statistics a second time. Equal parameter sets,
    outputs, gradients and running statistics with and without it."""
    gen = torch.Generator().manual_seed(0)
    nets = [ResNet(depth=18, num_stages=3, out_indices=(0, 1, 2), remat=remat)
            for remat in (False, True)]
    nets[1].load_state_dict(nets[0].state_dict())
    assert [n for n, _ in nets[0].named_parameters()] == [n for n, _ in nets[1].named_parameters()]
    x = torch.randn((2, 3, 32, 64), generator=gen)
    outs, grads = [], []
    for net in nets:
        net.train()
        out = net(x)
        sum((o ** 2).sum() for o in out).backward()
        outs.append([o.detach() for o in out])
        grads.append({n: p.grad for n, p in net.named_parameters()})
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-5, atol=1e-6 * float(g.abs().max()))
    for (n, a), (_, b) in zip(nets[0].named_buffers(), nets[1].named_buffers()):
        assert torch.equal(a, b), n
    assert int(nets[1].layer1_0.BatchNorm_0.num_batches_tracked) == 1
    # remat is inert in eval mode and under no_grad
    nets[1].eval()
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(nets[0].eval()(x), nets[1](x)))


# --------------------------------------------------------------------------
# one whole training step, f32 and bf16, norm_eval False and True
# --------------------------------------------------------------------------

def _no_dropout(next_fn, args, kwargs, context):
    """The JAX side's switch: every flax Dropout returns its input."""
    if isinstance(context.module, flax_nn.Dropout) and context.method_name == '__call__':
        return args[0]
    return next_fn(*args, **kwargs)


def _flipped(batch):
    """The batch in reverse order: identical math, other reduction orders."""
    return {k: v[::-1].copy() for k, v in batch.items()}


def _seeded_prediction_convs(variables, rng):
    """Small seeded normal weights for the two zero-initialised prediction
    convs, so that the detection loss's gradient reaches the network."""
    head = variables['params']['StereoHead_0']
    for node, std in ((head['Conv_0'], 0.005), (head['_ClsBranch_0']['Conv_2'], 0.02)):
        node['kernel'] = (std * rng.standard_normal(node['kernel'].shape)).astype(np.float32)
    return variables


@pytest.fixture(scope='module', params=[False, True], ids=['norm_eval_off', 'norm_eval_on'])
def step_pair(request, priors):
    norm_eval = request.param
    cfg = _tiny_cfg(priors, norm_eval)
    jsys = JAX_DETECTORS['Stereo3D'](copy.deepcopy(cfg))
    variables = _to_dict(jax.jit(lambda key: jsys.init(key, IMAGE_HW, batch_size=BATCH))(
        jax.random.PRNGKey(0)))
    variables = _seeded_prediction_convs(variables, np.random.default_rng(11))
    batch = _batch(12)
    train_cfg = testing.stereo_train_cfg(STEPS_PER_EPOCH)

    def jax_grad_fn(compute_dtype):
        mp_ctx, mp_cast = _mp_scope(compute_dtype)

        def loss_fn(params, b):
            with mp_ctx(), flax_nn.intercept_methods(_no_dropout):
                (cls_loss, reg_loss, terms), new_state = jsys.loss(
                    {'params': mp_cast(params), 'batch_stats': variables['batch_stats']},
                    b['left_images'], b['right_images'], b['P2'], b['P3'], b['annotations'],
                    disparity=b['disparity'], rng=jax.random.PRNGKey(1), train=True)
            return cls_loss.mean() + reg_loss.mean(), (terms, new_state['batch_stats'])
        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    # JAX f32: loss, gradients, new batch statistics, the optax update; and
    # the gradients of the reversed batch, the intrinsic noise floor
    grad_fn = jax_grad_fn(None)
    (j_loss, (j_terms, j_stats)), j_grads = grad_fn(variables['params'], batch)
    _, j_grads_flipped = grad_fn(variables['params'], _flipped(batch))
    tx = jax_build_optimizer(train_cfg.optimizer, train_cfg.scheduler, STEPS_PER_EPOCH)
    j_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, variables['params'])
    (j16_loss, (j16_terms, _)), j16_grads = jax_grad_fn('bfloat16')(variables['params'], batch)

    def bridged(tree, collection='params'):
        return convert.flax_to_state_dict({collection: _to_dict(tree)})[0]

    def port_step(compute_dtype):
        tsys = DETECTOR_DICT['Stereo3D'](copy.deepcopy(cfg), device='cpu', training=True)
        assert tsys.load_flax_variables(variables) == []  # the disparity head too
        tsys.dropout = False
        state = TrainState(build_optimizer(tsys.net.parameters(), train_cfg.optimizer,
                                           train_cfg.scheduler, STEPS_PER_EPOCH))
        # the gradients as the backward left them: the update clips them in place
        grads, update = {}, state.optimizer.step

        def recording_update():
            grads.update({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                          for n, p in tsys.net.named_parameters()})
            update()
        state.optimizer.step = recording_update
        cv.reset_launch_counts()
        metrics = PIPELINE_DICT['train_stereo_detection'](tsys, compute_dtype=compute_dtype)(
            state, batch)
        assert set(cv.LAUNCHES.values()) == {0}  # CPU: the plain forward and backward
        return dict(tsys=tsys, state=state, grads=grads,
                    metrics={k: float(v) for k, v in metrics.items()})

    return dict(
        norm_eval=norm_eval, lr=train_cfg.optimizer.keywords.lr,
        jax=dict(loss=float(j_loss), terms={k: float(v[0]) for k, v in j_terms.items()},
                 grads=bridged(j_grads), grads_flipped=bridged(j_grads_flipped),
                 params=bridged(j_params), stats=bridged(j_stats, 'batch_stats')),
        jax16=dict(loss=float(j16_loss), terms={k: float(v[0]) for k, v in j16_terms.items()},
                   grads=bridged(j16_grads)),
        port=port_step(None), port16=port_step('bfloat16'))


def test_train_step_loss_matches_jax(step_pair):
    """Every loss term (cls, reg, disparity, total) within rtol 2e-4, the
    JAX package's own bound for a change of reduction order."""
    terms, ref = step_pair['port']['metrics'], step_pair['jax']['terms']
    assert sorted(ref) == ['cls_loss', 'disparity_loss', 'reg_loss', 'total_loss']
    for name, value in ref.items():
        assert value > 0, name
        np.testing.assert_allclose(terms[name], value, rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(terms['total'], step_pair['jax']['loss'], rtol=2e-4)


def _flat(grads, prefix=''):
    return torch.cat([grads[n].double().ravel() for n in sorted(grads) if n.startswith(prefix)])


def _cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def test_train_step_gradients_match_jax(step_pair):
    """Self-calibrated, as in ``test_torch_km3d_train.py``: at random init
    a BN network's gradients move by percents under any change of
    summation order. The noise floor is the JAX gradient of the reversed
    batch. The port's largest elementwise difference is at most 8x the
    floor's (and 5e-2 of the largest gradient), its norm-wise difference
    over all parameters at most 3x the floor's. The disparity head and the
    trunk get gradients (through the correlation backward)."""
    grads = step_pair['port']['grads']
    ref, flipped = step_pair['jax']['grads'], step_pair['jax']['grads_flipped']
    assert sorted(ref) == sorted(grads)
    port_abs = max(float((grads[n] - g).abs().max()) for n, g in ref.items())
    floor_abs = max(float((flipped[n] - g).abs().max()) for n, g in ref.items())
    gmax = max(float(g.abs().max()) for g in ref.values())
    assert port_abs <= max(8 * floor_abs, 1e-5 * gmax), (port_abs, floor_abs, gmax)
    assert port_abs <= 5e-2 * gmax, (port_abs, gmax)
    den = float(_flat(ref).norm())
    port = float((_flat(grads) - _flat(ref)).norm()) / den
    floor = float((_flat(flipped) - _flat(ref)).norm()) / den
    assert port <= 3 * floor, (port, floor)
    for name in ('StereoMerging_0.CostVolumePyramid_0.Conv_0.weight',
                 'ResNet_0.layer1_0.Conv_0.weight'):
        assert float(grads[name].abs().max()) > 0, name


def test_train_step_batch_stats_and_params_match_jax(step_pair):
    tsys, ref = step_pair['port']['tsys'], step_pair['jax']
    buffers = dict(tsys.net.named_buffers())
    trunk_moved = []
    for name, value in ref['stats'].items():
        if name.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(), rtol=0,
                                   atol=1e-4 * float(value.abs().max()), err_msg=name)
        if name.startswith('ResNet_0.') and name.endswith('running_mean'):
            trunk_moved.append(bool(value.abs().max() > 0))
    # norm_eval keeps the trunk's statistics; without it they move
    assert trunk_moved and all(trunk_moved) == (not step_pair['norm_eval'])
    lr = step_pair['port']['state'].optimizer.schedule(0)
    assert lr == pytest.approx(step_pair['lr'])
    params = dict(tsys.net.named_parameters())
    worst = max(float((params[n].detach() - v).abs().max()) for n, v in ref['params'].items())
    assert worst <= 2.5 * lr, (worst, lr)
    state = step_pair['port']['state']
    assert state.step == 1 and state.optimizer.count == 1 and not tsys.net.training


def test_bf16_mixed_precision_step_matches_jax_bf16(step_pair):
    """The port's bf16 step against the JAX package's bf16 step (same
    weights and batch), with limits set by JAX's own bf16-to-f32 readings,
    as ``test_torch_km3d_train.py`` sets them: each loss term within 3x the
    larger of JAX's shift of that term and 1e-3 of its value; the head's
    gradients point the JAX bf16 way at least as well as JAX's bf16 points
    to its f32, less 0.05, and the port's f32 way as well, less 0.1; their
    size within 0.8-1.25 of JAX's bf16; all gradients together keep their
    size against f32 (0.8-1.25). Master parameters, their gradients and the
    running statistics stay f32."""
    tsys = step_pair['port16']['tsys']
    for p in tsys.net.parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
    for b in tsys.net.buffers():
        assert not b.is_floating_point() or b.dtype == torch.float32
    ref32 = dict(step_pair['jax']['terms'], total=step_pair['jax']['loss'])
    ref16 = dict(step_pair['jax16']['terms'], total=step_pair['jax16']['loss'])
    port16 = step_pair['port16']['metrics']
    for name, v32 in ref32.items():
        limit = 3 * max(abs(ref16[name] - v32), 1e-3 * abs(v32))
        assert abs(port16[name] - ref16[name]) <= max(limit, 1e-6), (name, port16[name],
                                                                    ref16[name], v32)
    head = 'StereoHead_0.'
    j32, j16 = _flat(step_pair['jax']['grads'], head), _flat(step_pair['jax16']['grads'], head)
    p32 = _flat(step_pair['port']['grads'], head)
    p16 = _flat(step_pair['port16']['grads'], head)
    jax_cos = _cos(j16, j32)
    assert _cos(p16, j16) >= jax_cos - 0.05, (_cos(p16, j16), jax_cos)
    assert _cos(p16, p32) >= jax_cos - 0.1, (_cos(p16, p32), jax_cos)
    assert 0.8 <= float(p16.norm() / j16.norm()) <= 1.25
    ratio = float(_flat(step_pair['port16']['grads']).norm()
                  / _flat(step_pair['port']['grads']).norm())
    assert 0.8 <= ratio <= 1.25, ratio


