"""The ported KM3D training slice against the JAX package, on the CPU.

Module by module (the target builder, the 3-D IoU, the loss terms and their
gradients, the flax-style BatchNorm, the schedules and optimizers, the skip
rule), then one whole f32 training step of KM3D (DLA-34 at 64x160,
``head_features=16``, batch 2) against ``jax.value_and_grad`` of the JAX
system's loss and an optax update, and one bf16 mixed-precision step
against the f32 one and against the JAX package's own bf16 step. Inputs
come from numpy seeds; the JAX side runs jitted, each JAX gradient once per
module (fixtures).

Weights of the whole-step test: JAX init through the weight bridge, then on
the port's side ``testing.prepare_km3d_for_training`` (running statistics
set to the batch's, offset convs seeded to 0.5 px; the head as initialised),
copied back into the flax tree, so both frameworks run the same weights
and the DCNs interpolate.

Tolerances (each with its reason at the assertion): exact for the target
builder; atol 1e-6 for the IoU; f32 loss terms within rtol 1e-5 and their
map gradients within 1e-5 of each gradient's max; the whole step's loss
terms within rtol 2e-4, and its gradients self-calibrated against the JAX
gradients of the reversed batch (a BN network at random init moves its
gradients by percents under any change of summation order); batch
statistics within 1e-4 of their largest value; parameters after the Adam
step within 2.5 * lr (a first Adam step moves each element by
lr * g / (|g| + eps), so the sign of a near-zero gradient costs up to
2 * lr), while the port's optimizers given the same gradients match optax
within two f32 ulps of each parameter; the bf16 step within limits set by
the JAX package's own bf16-to-f32 shift on the same fixture.
"""
import copy
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as flax_nn

from visualdet3d_tpu.data.kitti.dataset.km3d_dataset import KittiRTM3DDataset
from visualdet3d_tpu.data.kitti.kittidata import KittiObj as JaxKittiObj
from visualdet3d_tpu.models.heads import km3d_head as jax_km3d
from visualdet3d_tpu.pipelines.train_state import _mp_scope
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
from visualdet3d_tpu.solver.optimizers import build_optimizer as jax_build_optimizer
from visualdet3d_tpu.solver.optimizers import make_lr_schedule as jax_make_lr_schedule
import visualdet3d_tpu.models.detectors.km3d  # noqa: F401
from visualdet3d_tpu_torch import convert, testing
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.models import blocks
from visualdet3d_tpu_torch.data.kitti.dataset.km3d_dataset import RTM3DTargetBuilder
from visualdet3d_tpu_torch.data.kitti.kittidata import KittiObj
from visualdet3d_tpu_torch.models.blocks import BatchNorm2d, ModulatedDeformConv
from visualdet3d_tpu_torch.models.heads import km3d_head
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.ops import rotated_iou
from visualdet3d_tpu_torch.pipelines import trainers  # noqa: F401
from visualdet3d_tpu_torch.pipelines.train_state import TrainState
from visualdet3d_tpu_torch.registry import DETECTOR_DICT, PIPELINE_DICT
from visualdet3d_tpu_torch.solver.optimizers import build_optimizer, make_lr_schedule
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


# the JAX package's ops/__init__ exports a function of the module's name
jax_iou = importlib.import_module('visualdet3d_tpu.ops.rotated_iou')

IMAGE_HW = (64, 160)
BATCH = 2
EPOCH = 10.0


def _to_dict(tree):
    if hasattr(tree, 'items'):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def _scaled_p2(image_hw):
    p2 = testing.KITTI_P2.copy()
    p2[0] *= image_hw[1] / testing.KITTI_P2_HW[1]
    p2[1] *= image_hw[0] / testing.KITTI_P2_HW[0]
    return p2


# --------------------------------------------------------------------------
# host side: the target builder
# --------------------------------------------------------------------------

def _objects(cls, image_hw, P2):
    """Cars: inside the image, near and far, one partly outside (its right
    vertices leave the image), one wholly outside (no target), one beside
    another (overlapping heatmaps)."""
    specs = [  # x, y, z, ry, (l, t, r, b) as fractions of the image
        (-2.0, 1.6, 12.0, 0.3, (0.30, 0.40, 0.55, 0.80)),
        (4.0, 1.7, 25.0, -1.2, (0.62, 0.42, 0.72, 0.60)),
        (9.5, 1.5, 11.0, 2.5, (0.85, 0.35, 1.10, 0.90)),   # partly outside
        (30.0, 1.6, 10.0, 0.0, (1.20, 0.40, 1.40, 0.70)),  # wholly outside
        (-1.0, 1.6, 13.0, -2.8, (0.40, 0.45, 0.62, 0.78)),
    ]
    h, w = image_hw
    objs = []
    for x, y, z, ry, (l, t, r, b) in specs:
        o = cls()
        o.type, o.truncated, o.occluded = 'Car', 0.0, 0
        o.x, o.y, o.z, o.ry = x, y, z, ry
        o.h, o.w, o.l = 1.5, 1.6, 3.9
        o.alpha = 0.0
        o.bbox_l, o.bbox_t, o.bbox_r, o.bbox_b = l * w, t * h, r * w, b * h
        objs.append(o)
    return objs


def test_target_builder_matches_jax_exactly():
    image_hw = (96, 320)
    P2 = _scaled_p2(image_hw)
    ds = object.__new__(KittiRTM3DDataset)
    ds.obj_types, ds.num_classes, ds.max_objects = ['Car'], 1, 8
    ref = ds._build_target(np.zeros((*image_hw, 3), np.float32), P2.copy(),
                           _objects(JaxKittiObj, image_hw, P2))
    out = RTM3DTargetBuilder(['Car'], max_objects=8).build_target(
        image_hw, P2.copy(), _objects(KittiObj, image_hw, P2))
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].dtype == ref[key].dtype and out[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    # the cases are reached: four objects, one of them with vertices outside
    assert out['reg_mask'].tolist() == [1, 1, 1, 0, 1, 0, 0, 0]
    assert 0 < out['hp_mask'][18:27].sum() < 9
    collated = RTM3DTargetBuilder.collate_fn(
        [{'image': np.zeros((*image_hw, 3)), 'calib': P2, 'label': out}] * 2)
    assert collated['images'].dtype == np.float32 and collated['P2'].shape == (2, 3, 4)
    assert all(v.shape == (2, *out[k].shape) for k, v in collated['gts'].items())


def test_synthetic_training_batch_is_seeded_and_inside_the_image():
    a = testing.km3d_training_batch(np.random.default_rng(5), 3, IMAGE_HW)
    b = testing.km3d_training_batch(np.random.default_rng(5), 3, IMAGE_HW)
    for key in a['gts']:
        np.testing.assert_array_equal(a['gts'][key], b['gts'][key])
    np.testing.assert_array_equal(a['images'], b['images'])
    n = a['gts']['reg_mask'].sum(axis=1)
    assert (n >= 2).all() and (n <= 6).all()
    # every object's 9 keypoints are inside the stride-4 map
    keep = a['gts']['reg_mask'].astype(bool)
    assert (a['gts']['hps_mask'][keep] == 1).all()


# --------------------------------------------------------------------------
# the 3-D IoU
# --------------------------------------------------------------------------

IOU_BOXES_A = np.array([
    [0.0, 1.6, 10.0, 1.6, 1.5, 3.9, 0.3],    # rotated, overlaps B0
    [5.0, 1.6, 20.0, 1.6, 1.5, 3.9, 0.0],    # disjoint from all of B
    [-3.0, 1.7, 15.0, 2.0, 2.0, 5.0, -1.0],  # contains B2
    [2.0, 1.0, 12.0, 1.6, 1.5, 3.9, 1.57],   # height-offset against B3
], np.float32)
IOU_BOXES_B = np.array([
    [0.4, 1.6, 10.5, 1.7, 1.4, 4.1, -0.4],
    [-8.0, 1.6, 30.0, 1.6, 1.5, 3.9, 0.0],
    [-3.0, 1.5, 15.0, 1.0, 1.0, 2.0, -1.0],
    [2.0, 1.9, 12.0, 1.6, 1.5, 3.9, 1.57],
], np.float32)


def test_boxes_iou3d_matches_jax():
    ref = np.asarray(jax.jit(jax_iou.boxes_iou3d)(jnp.asarray(IOU_BOXES_A),
                                                  jnp.asarray(IOU_BOXES_B)))
    out = rotated_iou.boxes_iou3d(torch.from_numpy(IOU_BOXES_A), torch.from_numpy(IOU_BOXES_B))
    assert out.shape == (4, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    diag = np.diag(ref)
    assert diag[0] > 0.3 and diag[1] == 0 and diag[3] > 0   # the cases are reached
    np.testing.assert_allclose(diag[2], 2.0 / 20.0, atol=1e-6)  # nested: vol_b / vol_a
    aligned = rotated_iou.aligned_boxes_iou3d(torch.from_numpy(IOU_BOXES_A),
                                              torch.from_numpy(IOU_BOXES_B))
    np.testing.assert_allclose(aligned.numpy(), diag, atol=1e-6)


def test_rotated_iou_matches_jax():
    rng = np.random.default_rng(8)
    a = np.concatenate([rng.uniform(-2, 2, (6, 2)), rng.uniform(1, 4, (6, 2)),
                        rng.uniform(-3, 3, (6, 1))], 1).astype(np.float32)
    b = np.concatenate([rng.uniform(-2, 2, (5, 2)), rng.uniform(1, 4, (5, 2)),
                        rng.uniform(-3, 3, (5, 1))], 1).astype(np.float32)
    ref = np.asarray(jax.jit(jax_iou.rotated_iou)(jnp.asarray(a), jnp.asarray(b)))
    out = rotated_iou.rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert (ref > 0).mean() > 0.3 and (ref == 0).any()


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------

LOSS_MAP_STATS = {'hm': (-3.0, 1.5), 'hm_hp': (-3.0, 1.5), 'wh': (6.0, 2.0),
                  'hps': (0.0, 4.0), 'rot': (0.0, 1.0), 'dim': (2.0, 1.0),
                  'prob': (0.0, 1.0), 'reg': (0.5, 0.2), 'hp_offset': (0.5, 0.2)}


@pytest.fixture(scope='module')
def loss_case():
    rng = np.random.default_rng(9)
    batch = testing.km3d_training_batch(rng, BATCH, IMAGE_HW)
    h, w = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4
    maps = {name: rng.normal(mean, std, (BATCH, h, w, ch)).astype(np.float32)
            for name, ch in km3d_head.DEFAULT_HEAD_DICT.items()
            for mean, std in [LOSS_MAP_STATS[name]]}
    maps['hm'] = maps['hm'][..., :1]
    # a negative dim clears dim_ok of the first image's objects
    maps['dim'][0, ..., 0] = -np.abs(maps['dim'][0, ..., 0])

    def jax_loss(m):
        return jax_km3d.km3d_loss(m, batch['gts'], batch['P2'], jnp.float32(EPOCH), w)
    (ref_total, ref_terms), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in maps.items()})
    tmaps = {k: torch.from_numpy(v).requires_grad_() for k, v in maps.items()}
    gts = {k: torch.from_numpy(v) for k, v in batch['gts'].items()}
    total, terms = km3d_head.km3d_loss(tmaps, gts, torch.from_numpy(batch['P2']), EPOCH, w)
    total.backward()
    return (ref_total, ref_terms, ref_grads), (total, terms, {k: v.grad for k, v in tmaps.items()})


def test_km3d_loss_terms_match_jax(loss_case):
    (ref_total, ref_terms, _), (total, terms, _) = loss_case
    assert sorted(terms) == sorted(ref_terms)
    for name in ref_terms:
        np.testing.assert_allclose(float(terms[name].detach()), float(ref_terms[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert float(ref_terms['coor_loss']) > 0 and float(ref_terms['hm_loss']) > 0
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5)


def test_km3d_loss_grads_match_jax(loss_case):
    (_, _, ref_grads), (_, _, grads) = loss_case
    for name, ref in ref_grads.items():
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


# --------------------------------------------------------------------------
# BatchNorm, schedules, optimizers, the skip rule
# --------------------------------------------------------------------------

def test_batchnorm_train_mode_follows_flax():
    """n = 2 x 2 x 5 = 20 values per channel: torch's own update (unbiased
    variance) would differ from flax's by n / (n - 1), 5%."""
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((2, 2, 5, 6)) * 3 + 1).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 2, 6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    stats = {'mean': rng.standard_normal(6).astype(np.float32),
             'var': rng.uniform(0.5, 2, 6).astype(np.float32)}
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    ref, new = bn.apply({'params': {'scale': scale, 'bias': bias}, 'batch_stats': stats},
                        jnp.asarray(x), mutable=['batch_stats'])
    tbn = BatchNorm2d(6)
    convert.load_flax_variables(tbn, {'params': {'scale': scale, 'bias': bias},
                                      'batch_stats': stats})
    tbn.train()
    out = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(new['batch_stats']['mean']),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(new['batch_stats']['var']),
                               rtol=1e-6, atol=1e-6)
    # bf16 in, bf16 out; statistics and buffers stay f32
    y = tbn.to(torch.bfloat16).float()(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    assert y.dtype == torch.bfloat16 and tbn.running_var.dtype == torch.float32


SCHEDULES = {
    'none': None,
    'multistep': dict(type_name='MultiStepLR', keywords=dict(milestones=[3, 7], gamma=0.1)),
    'step': dict(type_name='StepLR', keywords=dict(step_size=4, gamma=0.5)),
    'exponential': dict(type_name='ExponentialLR', keywords=dict(gamma=0.9)),
    'cosine': dict(type_name='CosineAnnealingLR', keywords=dict(T_max=10, eta_min=1e-6)),
    'poly': dict(type_name='PolyLR', keywords=dict(gamma=0.9, n_iteration=12)),
    'warmup': dict(type_name='GradualWarmupScheduler', keywords=dict(
        multiplier=2.0, total_epoch=3,
        after_scheduler_cfg=dict(type_name='MultiStepLR',
                                 keywords=dict(milestones=[5], gamma=0.1)))),
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_lr_schedules_match_jax(name):
    cfg = None if SCHEDULES[name] is None else EasyDict(copy.deepcopy(SCHEDULES[name]))
    ref = jax_make_lr_schedule(cfg, 0.01, steps_per_unit=4)
    out = make_lr_schedule(cfg, 0.01, steps_per_unit=4)
    for step in (0, 1, 3, 4, 11, 12, 20, 27, 28, 40, 63, 100):
        np.testing.assert_allclose(out(step), float(ref(step)), rtol=2e-6, err_msg=str(step))


OPTIMIZERS = {
    'adam': dict(type_name='adam', keywords=dict(lr=1.25e-4, weight_decay=0)),
    'adam_decay_clip': dict(type_name='adam', keywords=dict(lr=1e-3, weight_decay=0.01),
                            clipped_gradient_norm=0.5),
    'adamw': dict(type_name='adamw', keywords=dict(lr=1e-3, weight_decay=0.05)),
    'sgd': dict(type_name='sgd', keywords=dict(lr=0.01, momentum=0.9, weight_decay=1e-3)),
}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    """Three updates from the same gradients, with a MultiStepLR schedule
    stepping in between: the port's update equals optax's."""
    cfg = EasyDict(copy.deepcopy(OPTIMIZERS[name]))
    sched = EasyDict(type_name='MultiStepLR', keywords=dict(milestones=[2], gamma=0.1))
    rng = np.random.default_rng(11)
    params = {'a': rng.standard_normal((4, 3)).astype(np.float32),
              'b': rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jax_build_optimizer(cfg, sched, steps_per_unit=1)
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = build_optimizer(tp.values(), cfg, sched, steps_per_unit=1)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    lr = float(OPTIMIZERS[name]['keywords']['lr'])
    for k, p in tp.items():
        # two f32 ulps of the parameter (the rounding of p - lr * u on each side)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=2.5e-7,
                                   atol=1e-6 * lr, err_msg=k)
    assert opt.count == 3


class _StubSystem:
    """A system whose loss is ``scale * sum(net(x))``: zero when scale is 0."""

    def __init__(self):
        self.net = torch.nn.Linear(3, 2)
        self.changed = 0

    def loss(self, images, gts, P2, epoch=100.0, apply_fn=None):
        total = gts * self.net(images).square().sum()
        return total, {'total_loss': total}

    def weights_changed(self):
        self.changed += 1


def test_skip_rule_keeps_params_and_adam_state():
    """A zero loss leaves the parameters and the Adam state (moments and
    its step) as they were while the step count advances, as the JAX step's
    where-mask over params and opt_state does."""
    system = _StubSystem()
    cfg = testing.km3d_train_cfg()
    state = TrainState(build_optimizer(system.net.parameters(), cfg.optimizer, cfg.scheduler))
    step = PIPELINE_DICT['train_rtm3d'](system)
    x = torch.randn(4, 3)
    step(state, {'images': x, 'gts': 1.0, 'P2': None})
    before = {k: v.clone() for k, v in system.net.state_dict().items()}
    adam = {id(p): {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
            for p, s in state.optimizer.torch_optimizer.state.items()}
    metrics = step(state, {'images': x, 'gts': 0.0, 'P2': None})
    assert float(metrics['total']) == 0.0
    assert state.step == 2 and state.optimizer.count == 1 and system.changed == 1
    for k, v in system.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in state.optimizer.torch_optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(adam[id(p)][k])), k
    step(state, {'images': x, 'gts': 1.0, 'P2': None})
    assert state.step == 3 and state.optimizer.count == 2 and system.changed == 2


# --------------------------------------------------------------------------
# one whole training step
# --------------------------------------------------------------------------

def _copy_to_flax(variables, tsys):
    """The port's seeded convs and running statistics back into the flax tree."""
    state = {k: v.detach().numpy() for k, v in tsys.net.state_dict().items()}
    for name, m in tsys.net.named_modules():
        node = None
        if isinstance(m, ModulatedDeformConv):
            node, conv = variables['params'], m.Conv_0
            path = f'{name}.Conv_0'
        elif name.startswith('KM3DHeadNet_0.') and name.endswith('_out'):
            node, conv, path = variables['params'], m, name
        if node is not None:
            for part in path.split('.'):
                node = node[part]
            node['kernel'] = conv.weight.detach().permute(2, 3, 1, 0).contiguous().numpy()
            node['bias'] = conv.bias.detach().numpy().copy()
        if isinstance(m, BatchNorm2d):
            node = variables['batch_stats']
            for part in name.split('.'):
                node = node[part]
            node['mean'] = state[f'{name}.running_mean'].copy()
            node['var'] = state[f'{name}.running_var'].copy()


def _flipped(batch):
    """The batch in reverse order: identical math, other reduction orders."""
    return {'images': batch['images'][::-1].copy(), 'P2': batch['P2'][::-1].copy(),
            'gts': {k: v[::-1].copy() for k, v in batch['gts'].items()}}


@pytest.fixture(scope='module')
def step_pair():
    cfg = testing.km3d_detector_cfg(head_features=16, top_k=20)
    jsys = JAX_DETECTORS['KM3D'](EasyDict(copy.deepcopy(cfg)))
    variables = _to_dict(jax.jit(lambda key: jsys.init(key, IMAGE_HW, batch_size=BATCH))(
        jax.random.PRNGKey(0)))
    tsys = DETECTOR_DICT['KM3D'](EasyDict(copy.deepcopy(cfg)), device='cpu')
    assert tsys.load_flax_variables(variables) == []
    batch = testing.km3d_training_batch(np.random.default_rng(12), BATCH, IMAGE_HW)
    testing.prepare_km3d_for_training(tsys, torch.from_numpy(batch['images']),
                                      torch.Generator().manual_seed(13), offset_std=0.5,
                                      calibrate_head=False)
    _copy_to_flax(variables, tsys)
    init_state = copy.deepcopy(tsys.net.state_dict())
    train_cfg = testing.km3d_train_cfg(steps_per_epoch=10)

    # JAX: loss, gradients and new batch statistics, then the optax update;
    # and the gradients of the reversed batch, the intrinsic noise floor
    def loss_fn(params, b):
        (loss, terms), new_state = jsys.loss({'params': params,
                                              'batch_stats': variables['batch_stats']},
                                             b['images'], b['gts'], b['P2'],
                                             train=True, epoch=EPOCH)
        return loss, (terms, new_state['batch_stats'])
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (j_loss, (j_terms, j_stats)), j_grads = grad_fn(variables['params'], batch)
    _, j_grads_flipped = grad_fn(variables['params'], _flipped(batch))
    tx = jax_build_optimizer(train_cfg.optimizer, train_cfg.scheduler, 10)
    # jitted: run op by op over the whole parameter tree, optax takes ~25 s
    j_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, variables['params'])

    # the port: one step of the registered trainer
    state = TrainState(build_optimizer(tsys.net.parameters(), train_cfg.optimizer,
                                       train_cfg.scheduler, 10))
    metrics = PIPELINE_DICT['train_rtm3d'](tsys)(state, dict(batch, epoch=EPOCH))

    def bridged(tree, collection='params'):
        return convert.flax_to_state_dict({collection: _to_dict(tree)})[0]
    jax_side = dict(loss=float(j_loss), terms={k: float(v) for k, v in j_terms.items()},
                    grads=bridged(j_grads), grads_flipped=bridged(j_grads_flipped),
                    params=bridged(j_params), stats=bridged(j_stats, 'batch_stats'))
    return dict(cfg=cfg, batch=batch, init=init_state, train_cfg=train_cfg, tsys=tsys,
                metrics={k: float(v) for k, v in metrics.items()}, state=state, jax=jax_side,
                jsys=jsys, variables=variables)


def test_train_step_loss_matches_jax(step_pair):
    """Every loss term within rtol 2e-4, the JAX package's own bound for a
    change of reduction order (``tests/test_km3d.py``)."""
    terms, ref = step_pair['metrics'], step_pair['jax']['terms']
    for name, value in ref.items():
        np.testing.assert_allclose(terms[name], value, rtol=2e-4, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(terms['total'], step_pair['jax']['loss'], rtol=2e-4)
    assert ref['coor_loss'] > 0 and ref['prob_loss'] > 0


def test_train_step_gradients_match_jax(step_pair):
    """Self-calibrated, as the JAX package gates its own sharded gradients
    (``tests/test_km3d.py``): at random init a BN network's gradients move
    by percents under any change of summation order (the DCN's corner
    choice, ReLU kinks and the position solve turn last-bit differences into
    gradient differences; a conv bias before BN has a true gradient of 0).
    The noise floor is the JAX gradient of the reversed batch. The port's
    largest elementwise difference is at most 8x the floor's (and 5e-2 of
    the largest gradient), and its norm-wise difference over all parameters
    at most 3x the floor's."""
    params = dict(step_pair['tsys'].net.named_parameters())
    ref, flipped = step_pair['jax']['grads'], step_pair['jax']['grads_flipped']
    assert sorted(ref) == sorted(params)

    def grad(name):  # parameters the loss does not reach have no .grad
        g = params[name].grad
        return torch.zeros_like(params[name]) if g is None else g
    port_abs = max(float((grad(n) - g).abs().max()) for n, g in ref.items())
    floor_abs = max(float((flipped[n] - g).abs().max()) for n, g in ref.items())
    gmax = max(float(g.abs().max()) for g in ref.values())
    assert port_abs <= max(8 * floor_abs, 1e-5 * gmax), (port_abs, floor_abs, gmax)
    assert port_abs <= 5e-2 * gmax, (port_abs, gmax)
    den = sum(float(g.double().norm()) ** 2 for g in ref.values())
    port = sum(float((grad(n).double() - g.double()).norm()) ** 2 for n, g in ref.items())
    floor = sum(float((flipped[n].double() - g.double()).norm()) ** 2 for n, g in ref.items())
    assert (port / den) ** 0.5 <= 3 * (floor / den) ** 0.5, ((port / den) ** 0.5,
                                                             (floor / den) ** 0.5)
    # every DCN's weight and offset conv gets a gradient
    dcn = [n for n in params if n.endswith('ModulatedDeformConv_0.weight')
           or n.endswith('ModulatedDeformConv_0.Conv_0.weight')]
    assert len(dcn) == 32 and all(float(grad(n).abs().max()) > 0 for n in dcn)


def test_train_step_batch_stats_and_params_match_jax(step_pair):
    tsys, ref = step_pair['tsys'], step_pair['jax']
    buffers = dict(tsys.net.named_buffers())
    for name, value in ref['stats'].items():
        if name.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(), rtol=0,
                                   atol=1e-4 * float(value.abs().max()), err_msg=name)
    lr = step_pair['state'].optimizer.schedule(0)
    params = dict(tsys.net.named_parameters())
    worst = max(float((params[n].detach() - v).abs().max()) for n, v in ref['params'].items())
    assert worst <= 2.5 * lr, (worst, lr)
    assert step_pair['state'].step == 1 and step_pair['state'].optimizer.count == 1


@pytest.fixture(scope='module')
def bf16_pair(step_pair):
    """The bf16 mixed-precision step from the f32 step's weights, in both
    frameworks: JAX's gradient under its own policy (``_mp_scope``: the
    DCNs take K3 and K7, in interpret mode here), and one step of the
    port's registered trainer, with hooks recording the dtypes that every
    conv, DCN and BatchNorm sees."""
    jsys, variables, batch = step_pair['jsys'], step_pair['variables'], step_pair['batch']
    mp_ctx, mp_cast = _mp_scope('bfloat16')

    def loss_fn(params):
        with mp_ctx():
            (loss, terms), _ = jsys.loss({'params': mp_cast(params),
                                          'batch_stats': variables['batch_stats']},
                                         batch['images'], batch['gts'], batch['P2'],
                                         train=True, epoch=EPOCH)
        return loss, terms
    (j_loss, j_terms), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])

    tsys = DETECTOR_DICT['KM3D'](EasyDict(copy.deepcopy(step_pair['cfg'])), device='cpu')
    tsys.net.load_state_dict(step_pair['init'])
    train_cfg = step_pair['train_cfg']
    state = TrainState(build_optimizer(tsys.net.parameters(), train_cfg.optimizer,
                                       train_cfg.scheduler, 10))
    seen = {'conv': [], 'dcn': [], 'bn': []}
    hooks = []
    for name, m in tsys.net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_pre_hook(
                lambda m, args, name=name: seen['conv'].append(
                    (name, *(t.dtype for t in (args[0], m.weight, m.bias) if t is not None)))))
        elif isinstance(m, BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda m, args, out, name=name: seen['bn'].append(
                    (name, args[0].dtype, out.dtype))))
    dcn_op = blocks.modulated_deform_conv

    def recording_dcn(*args, **kwargs):
        seen['dcn'].append(tuple(a.dtype for a in args if torch.is_tensor(a)))
        return dcn_op(*args, **kwargs)
    blocks.modulated_deform_conv = recording_dcn
    try:
        metrics = PIPELINE_DICT['train_rtm3d'](tsys, compute_dtype='bfloat16')(
            state, dict(batch, epoch=EPOCH))
    finally:
        blocks.modulated_deform_conv = dcn_op
        for h in hooks:
            h.remove()
    jax_side = dict(loss=float(j_loss), terms={k: float(v) for k, v in j_terms.items()},
                    grads=convert.flax_to_state_dict({'params': _to_dict(j_grads)})[0])
    return dict(tsys=tsys, metrics={k: float(v) for k, v in metrics.items()}, seen=seen,
                jax=jax_side)


def _grads(tsys):
    """Every parameter's gradient by name (zeros where the loss does not reach)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in tsys.net.named_parameters()}


def _flat(grads, prefix=''):
    return torch.cat([grads[n].double().ravel() for n in sorted(grads) if n.startswith(prefix)])


def _cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def test_bf16_mixed_precision_step(step_pair, bf16_pair):
    """The policy, shown by the dtypes each module sees: every conv (the
    trunk's, the DCN offset convs, the head towers) takes bf16 inputs,
    weights and biases; every DCN bf16 x, offsets, mask, weight and bias (so
    the card runs K3 and K7); every BatchNorm returns bf16. Master
    parameters, their gradients and the running statistics stay f32, and
    the network is back in eval mode.

    The loss (f32, from upcast maps) moves from the f32 step's by at most
    twice what the JAX package's own policy moves it, and by more than a
    tenth of that (the step did run in bf16). Measured on this fixture:
    the JAX policy moves the loss by 1.65e-3 of its value, the port's by
    1.56e-3; a gate of 1e-3 would fail the JAX package itself. At random
    init both frameworks' bf16 activations drift far from f32 with depth
    (train-mode BatchNorm amplifies each rounding: 25% norm-wise at the
    stride-32 level, ~60% at the neck's output, in both)."""
    t32, t16 = step_pair['tsys'], bf16_pair['tsys']
    for p in t16.net.parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
    for b in t16.net.buffers():
        assert not b.is_floating_point() or b.dtype == torch.float32
    seen = bf16_pair['seen']
    convs = [n for n, m in t16.net.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert sorted(n for n, *_ in seen['conv']) == sorted(convs)
    assert all(len(dtypes) >= 2 and set(dtypes) == {torch.bfloat16}
               for _, *dtypes in seen['conv']), seen['conv']
    assert sum('ModulatedDeformConv_0.Conv_0' in n for n in convs) == 16
    assert len(seen['dcn']) == 16
    assert all(dtypes == (torch.bfloat16,) * 5 for dtypes in seen['dcn']), seen['dcn']
    bns = [n for n, m in t16.net.named_modules() if isinstance(m, BatchNorm2d)]
    assert sorted(n for n, *_ in seen['bn']) == sorted(bns)
    assert all(dtypes == [torch.bfloat16] * 2 for _, *dtypes in seen['bn']), seen['bn']
    assert not t16.net.training and set(dc.LAUNCHES.values()) == {0}

    j32, j16 = step_pair['jax']['loss'], bf16_pair['jax']['loss']
    p32, p16 = step_pair['metrics']['total'], bf16_pair['metrics']['total']
    jax_shift = abs(j16 - j32) / abs(j32)
    port_shift = abs(p16 - p32) / abs(p32)
    assert 0.1 * jax_shift < port_shift <= 2 * jax_shift, (port_shift, jax_shift)


def test_bf16_mixed_precision_step_matches_jax_bf16(step_pair, bf16_pair):
    """The port's bf16 step against the JAX package's bf16 step (same
    weights and batch), with limits set by JAX's own bf16-to-f32 readings.
    Each loss term within 3x the larger of JAX's shift of that term and
    1e-3 of its value (measured at most 0.65 of that limit). The head's
    gradients (where the direction survives bf16: the trunk's cosine to
    f32 is 0.156 under the JAX policy itself) point the JAX bf16 way at
    least as well as JAX's bf16 points to its f32, less 0.05 (measured
    0.860 against 0.827), and the port's f32 way as well as JAX's, less 0.1
    (0.791 against 0.827); their size within 0.8-1.25 of JAX's bf16 (1.037).
    All gradients together keep their size against f32 (0.996; JAX 1.020).

    The two bf16 steps round at different places: XLA keeps excess
    precision inside its fusions (``xla_allow_excess_precision``, on by
    default), skipping the bf16 round trips between a conv and its norm
    that the policy states; with it off the JAX package's per-layer bf16
    error equals the port's (3.34e-3 against 3.34e-3 after the first
    BatchNorm, 0.59 against 0.61 at the neck's output)."""
    ref32, ref16 = dict(step_pair['jax']['terms']), dict(bf16_pair['jax']['terms'])
    ref32['total'], ref16['total'] = step_pair['jax']['loss'], bf16_pair['jax']['loss']
    port16 = bf16_pair['metrics']
    for name, v32 in ref32.items():
        limit = 3 * max(abs(ref16[name] - v32), 1e-3 * abs(v32))
        assert abs(port16[name] - ref16[name]) <= max(limit, 1e-6), (name, port16[name],
                                                                    ref16[name], v32)
    head = 'KM3DHeadNet_0.'
    j32, j16 = _flat(step_pair['jax']['grads'], head), _flat(bf16_pair['jax']['grads'], head)
    p32, p16 = _flat(_grads(step_pair['tsys']), head), _flat(_grads(bf16_pair['tsys']), head)
    jax_cos = _cos(j16, j32)
    assert _cos(p16, j16) >= jax_cos - 0.05, (_cos(p16, j16), jax_cos)
    assert _cos(p16, p32) >= jax_cos - 0.1, (_cos(p16, p32), jax_cos)
    assert 0.8 <= float(p16.norm() / j16.norm()) <= 1.25
    ratio = float(_flat(_grads(bf16_pair['tsys'])).norm() / _flat(_grads(step_pair['tsys'])).norm())
    assert 0.8 <= ratio <= 1.25, ratio
