"""Data-parallel training with synchronised BatchNorm (``parallel/mesh.py``)
on the CPU: gloo process groups of two processes against one process on
the whole batch, and against the JAX package's data-parallel step.

The JAX package's step is one jitted step over the global batch, so the
port's two-process step must be the single-process step on the
concatenated batch, up to f32 reduction order: every process computes the
global loss, its BatchNorms take the global statistics, and the averaged
gradients are the global batch's. Each group runs ``tests/_parallel_worker.py``
in two subprocesses (a spawn costs ~5 s here); the same functions run in
this process without a group on the whole batch as the reference.

* every batch reduction of the losses (detection, KM3D with the rtm3d
  terms, MonoFlex, the stereo focal disparity loss, RetinaNet, MonoDepth's
  SI-log and smoothness): every process's value equals the whole batch's
  (rtol 1e-5: f32 sums in another order), and each process's input
  gradient, divided by the world size (the average over the processes),
  equals the whole batch's gradient on its rows (1e-5 of the largest);
* ``BatchNorm2d``/``3d`` in train mode: outputs, input and parameter
  gradients, running statistics, within 1e-5 of the largest value (the
  global fast variance against ``F.batch_norm``'s two-pass one);
* the class tower's dropout: the global batch's mask, bit for bit;
* a tiny stereo step (ResNet-18 at 64x160, 2 processes x 2 items; weights
  seeded in a flax tree of the port's modules) against the single-process
  step on the 4 items, once with boxes in every image
  and once with none in the second process's half: the loss terms within
  rtol 1e-5, the gradients self-calibrated as in
  ``tests/test_torch_stereo_train.py`` (against the single-process
  gradient of the reversed batch), the parameters after the Adam step
  within 2.5 x lr, the running statistics within 1e-4 of their largest
  value; and the same two-process step against the JAX package's
  data-parallel step on a 2-device CPU mesh, under that file's gates;
* ``python -m visualdet3d_tpu_torch.cli.train`` as two processes on the
  JAX tests' mini KITTI tree: both exit 0 holding equal parameters, and
  only process 0 writes;
* without a group every helper is the identity; in a group of one the
  sum, the gradient average and the dropout mask leave values bit for
  bit, and the losses and BatchNorms are the single-process ones within
  f32 rounding.
"""
import copy
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import optax
import pytest
import torch
from flax import linen as flax_nn

from visualdet3d_tpu.parallel import mesh as jax_mesh
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
from visualdet3d_tpu.solver.optimizers import build_optimizer as jax_build_optimizer
import visualdet3d_tpu.models.detectors.yolostereo3d  # noqa: F401
from visualdet3d_tpu_torch import convert, testing
from visualdet3d_tpu_torch.cli import imdb_precompute_3d
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.parallel import mesh
from visualdet3d_tpu_torch.registry import DETECTOR_DICT
import visualdet3d_tpu_torch.models  # noqa: F401

import _parallel_worker as worker
from helpers import write_fake_priors
from kitti_fixture import build_mini_kitti, write_split_files
from test_stereo_system import IMAGE_HW, sample_P, tiny_stereo_cfg
from test_torch_cli_train import TINY_HW, _paths, _write_config
from test_torch_int8 import _flax_variables
from test_torch_stereo_train import _no_dropout, _seeded_prediction_convs, _to_dict

WORLD = 2
BATCH = 4  # the losses' global batch: 2 items a process
STEP_BATCH = 4  # the stereo step's: 2 items a process (the reversed batch then moves
                # items between the processes, which changes the order of the sums)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_parallel_worker.py')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (the tier-1 run
    puts six workers on one machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=ROOT)


def _start_group(case, spec, tmp, world=WORLD):
    """Start ``case`` of the worker in ``world`` processes of one gloo
    group; ``_results`` waits for them. The caller computes its reference
    meanwhile."""
    torch.save(spec, tmp / f'{case}.in.pt')
    port = _free_port()
    return case, tmp, [subprocess.Popen(
        [sys.executable, WORKER, case, str(r), str(world), str(port), str(tmp)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _results(group):
    """Each process's result of a ``_start_group``."""
    case, tmp, procs = group
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), outs
    return [torch.load(tmp / f'{case}.rank{r}.pt', weights_only=False)
            for r in range(len(procs))]


def _rows(t, r, world=WORLD):
    n = t.shape[0] // world
    return t[r * n:(r + 1) * n]


# --------------------------------------------------------------------------
# the losses, BatchNorm and dropout
# --------------------------------------------------------------------------

def _detection_inputs(rng):
    """Anchors on a 16-pixel grid, boxes near them (4, 1, 0 and 2 a
    image), random predictions."""
    h, w = IMAGE_HW
    ys, xs = np.meshgrid(np.arange(8, h, 16), np.arange(8, w, 16), indexing='ij')
    anchors = np.concatenate([np.stack([xs.ravel() - bw / 2, ys.ravel() - bh / 2,
                                        xs.ravel() + bw / 2, ys.ravel() + bh / 2], 1)
                              for bw, bh in ((24, 24), (32, 32), (34, 17))]).astype(np.float32)
    n = anchors.shape[0]
    ann = np.full((BATCH, 5, 12), -1.0, np.float32)
    for b, count in enumerate((4, 1, 0, 2)):
        for j in range(count):
            a = anchors[rng.integers(n)] + rng.uniform(-2, 2, 4)
            ann[b, j] = [*a, rng.integers(0, 2), (a[0] + a[2]) / 2, (a[1] + a[3]) / 2,
                         rng.uniform(5, 40), 1.6, 1.5, 3.9, rng.uniform(-np.pi, np.pi)]
    mean_std = np.stack([rng.uniform(1, 30, (n, 2, 6)), rng.uniform(0.5, 8, (n, 2, 6))],
                        -1).astype(np.float32)
    batched = dict(cls=rng.normal(-1, 2, (BATCH, n, 3)).astype(np.float32),
                   reg=rng.normal(0, 1, (BATCH, n, 12)).astype(np.float32),
                   useful=rng.uniform(size=(BATCH, n)) > 0.1, ann=ann)
    consts = dict(anchors=torch.from_numpy(anchors), mean_std=torch.from_numpy(mean_std),
                  kw=dict(num_classes=2, focal_loss_gamma=2.0, balance_weights=[20.0, 40.0],
                          regression_weight=[1, 1, 1, 1, 1, 1, 12, 1, 1, 0.5, 0.5, 0.5, 1],
                          L1_regression_alpha=25.0))
    return batched, consts, ('cls', 'reg')


MAP_STATS = {'hm': (-2.0, 1.0), 'hm_hp': (-2.0, 1.0), 'wh': (6.0, 1.0), 'hps': (0.0, 2.0),
             'rot': (0.0, 1.0), 'dim': (1.5, 0.3), 'prob': (0.0, 1.0), 'reg': (0.5, 0.1),
             'hp_offset': (0.5, 0.1), 'bbox2d': (6.0, 1.0), 'depth': (0.0, 1.0),
             'depth_uncertainty': (0.0, 0.5), 'corner_uncertainty': (0.0, 0.5)}


def _rtm3d_inputs(rng, make_batch, head_dict):
    """A synthetic batch's targets and random NHWC maps at stride 4."""
    b = make_batch(rng, BATCH, IMAGE_HW)
    h, w = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4
    output = {k: rng.normal(*MAP_STATS[k], (BATCH, h, w, c)).astype(np.float32)
              for k, c in head_dict.items()}
    batched = dict(output=output, gts=b['gts'], P2=b['P2'])
    return batched, dict(output_w=w), tuple(f'output.{k}' for k in head_dict)


def _retinanet_inputs(rng):
    cfg = testing.retinanet_detector_cfg(depth=18)
    hw = (64, 128)
    anchors = DETECTOR_DICT['RetinaNet'](copy.deepcopy(cfg), device='cpu').anchor_pack(hw).numpy()
    n = anchors.shape[0]
    ann = np.full((BATCH, 4, 5), -1.0, np.float32)
    for b, count in enumerate((2, 0, 3, 1)):
        for j in range(count):
            ann[b, j] = [*(anchors[rng.integers(n)] + rng.uniform(-2, 2, 4)), rng.integers(0, 3)]
    batched = dict(images=np.zeros((BATCH, *hw, 3), np.float32), ann=ann,
                   cls=rng.normal(-3, 1.5, (BATCH, n, 3)).astype(np.float32),
                   reg=rng.normal(0, 0.2, (BATCH, n, 4)).astype(np.float32))
    return batched, dict(cfg=cfg), ('cls', 'reg')


def _loss_inputs():
    rng = np.random.default_rng(20)
    h, w = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4
    disp = np.abs(rng.standard_normal((BATCH, *IMAGE_HW))).astype(np.float32) * 5
    disp[rng.uniform(size=disp.shape) < 0.5] = 0.0  # sparse
    gt = rng.uniform(1, 60, (BATCH, h, w)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.4] = 0.0
    return {
        'detection_3d': _detection_inputs(rng),
        'km3d': _rtm3d_inputs(rng, testing.km3d_training_batch,
                              {'hm': 1, 'wh': 2, 'hps': 18, 'rot': 8, 'dim': 3, 'prob': 1,
                               'reg': 2, 'hm_hp': 9, 'hp_offset': 2}),
        'monoflex': _rtm3d_inputs(rng, testing.monoflex_training_batch,
                                  {'hm': 1, 'bbox2d': 4, 'hps': 20, 'rot': 8, 'dim': 3,
                                   'depth': 1, 'depth_uncertainty': 1, 'corner_uncertainty': 3,
                                   'reg': 2}),
        'stereo_focal': (dict(cost=rng.standard_normal((BATCH, h, w, 24)).astype(np.float32),
                              disp=disp), {}, ('cost',)),
        'monodepth': (dict(log_depth=rng.normal(2.5, 0.5, (BATCH, h, w)).astype(np.float32),
                           gt=gt, image=rng.uniform(0, 1, (BATCH, h, w, 3)).astype(np.float32)),
                      {}, ('log_depth',)),
        'retinanet': _retinanet_inputs(rng),
    }


@pytest.fixture(scope='module')
def units(tmp_path_factory):
    rng = np.random.default_rng(21)
    spec = {'losses': _loss_inputs()}
    for name, shape in (('bn2d', (BATCH, 6, 5, 7)), ('bn3d', (BATCH, 4, 3, 5, 6))):
        c = shape[1]
        spec[name] = (torch.from_numpy((rng.standard_normal(shape) * 3 + 1).astype(np.float32)),
                      torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                      torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32)),
                      torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
    spec['dropout'] = torch.from_numpy(rng.standard_normal((BATCH, 8, 3, 4)).astype(np.float32))
    group = _start_group('units', spec, tmp_path_factory.mktemp('units'))
    ref = worker.units_case(spec)
    return dict(spec=spec, ranks=_results(group), ref=ref)


@pytest.mark.parametrize('name', ['detection_3d', 'km3d', 'monoflex', 'stereo_focal',
                                  'retinanet', 'monodepth'])
def test_loss_is_the_whole_batch_loss(units, name):
    ref_value, ref_grads = units['ref']['losses'][name]
    assert float(ref_value) > 0 and np.isfinite(float(ref_value))
    for r, out in enumerate(units['ranks']):
        value, grads = out['losses'][name]
        assert torch.equal(value, units['ranks'][0]['losses'][name][0])  # one global value
        np.testing.assert_allclose(float(value), float(ref_value), rtol=1e-5, err_msg=name)
        for key, ref in ref_grads.items():
            scale = float(ref.abs().max())
            assert scale > 0, (name, key)
            got = grads[key] / WORLD  # the average of the processes' gradients
            assert got.shape == _rows(ref, r).shape
            err = float((got - _rows(ref, r)).abs().max())
            assert err <= 1e-5 * scale, (name, key, r, err, scale)


@pytest.mark.parametrize('name', ['bn2d', 'bn3d'])
def test_batchnorm_takes_the_global_statistics(units, name):
    ref = units['ref'][name]
    for r, out in enumerate(units['ranks']):
        got = out[name]
        for key, want in (('y', _rows(ref['y'], r)), ('dx', _rows(ref['dx'], r) * WORLD),
                          ('dw', ref['dw']), ('db', ref['db']), ('mean', ref['mean']),
                          ('var', ref['var'])):
            err = float((got[key] - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (name, key, r, err)
        np.testing.assert_allclose(float(got['loss']), float(ref['loss']), rtol=1e-5)


def test_dropout_draws_the_global_mask(units):
    ref = units['ref']['dropout']
    assert float((ref == 0).float().mean()) > 0.1  # channels were dropped
    for r, out in enumerate(units['ranks']):
        assert torch.equal(out['dropout'], _rows(ref, r))


# --------------------------------------------------------------------------
# the stereo step: two processes, one process, the JAX data-parallel step
# --------------------------------------------------------------------------

def _flipped(batch):
    """The batch in reverse order: identical math, other reduction orders."""
    return {k: v[::-1].copy() for k, v in batch.items()}


@pytest.fixture(scope='module')
def stereo(tmp_path_factory):
    pre = str(tmp_path_factory.mktemp('pre'))
    write_fake_priors(pre, ['Car', 'Pedestrian'])
    cfg = EasyDict(copy.deepcopy(tiny_stereo_cfg(pre)))
    jsys = JAX_DETECTORS['Stereo3D'](copy.deepcopy(cfg))
    tsys = DETECTOR_DICT['Stereo3D'](copy.deepcopy(cfg), device='cpu', training=True)
    variables = _seeded_prediction_convs(_flax_variables(tsys.net, np.random.default_rng(10)),
                                         np.random.default_rng(11))
    assert tsys.load_flax_variables(variables) == []
    batch = testing.stereo_training_batch(np.random.default_rng(12), STEP_BATCH, IMAGE_HW)
    batch = dict(batch, P2=sample_P(STEP_BATCH), P3=sample_P(STEP_BATCH, tx=-120.0))
    half = dict(batch, annotations=batch['annotations'].copy())
    half['annotations'][STEP_BATCH // 2:] = -1.0  # the second process's half has no box
    train_cfg = testing.stereo_train_cfg(worker.STEPS_PER_EPOCH)
    spec = dict(cfg=cfg, state=tsys.net.state_dict(), batches=[batch, half], train_cfg=train_cfg)
    group = _start_group('stereo', spec, tmp_path_factory.mktemp('stereo'))
    single = worker.stereo_case(spec)
    flipped = worker.stereo_case(dict(spec, batches=[_flipped(b) for b in spec['batches']]))

    # the JAX package's step over a 2-device data mesh
    m = jax_mesh.make_mesh(jax.devices()[:WORLD])

    def loss_fn(params, b):
        with flax_nn.intercept_methods(_no_dropout):
            (cls_loss, reg_loss, terms), new_state = jsys.loss(
                {'params': params, 'batch_stats': variables['batch_stats']},
                b['left_images'], b['right_images'], b['P2'], b['P3'], b['annotations'],
                disparity=b['disparity'], rng=jax.random.PRNGKey(1), train=True)
        return cls_loss.mean() + reg_loss.mean(), (terms, new_state['batch_stats'])
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params = jax_mesh.replicate(m, variables['params'])
    (j_loss, (j_terms, j_stats)), j_grads = grad_fn(params, jax_mesh.shard_batch(m, batch))
    _, j_flipped = grad_fn(params, jax_mesh.shard_batch(m, _flipped(batch)))
    tx = jax_build_optimizer(train_cfg.optimizer, train_cfg.scheduler, worker.STEPS_PER_EPOCH)
    j_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, params)

    def bridged(tree, collection='params'):
        return convert.flax_to_state_dict({collection: _to_dict(tree)})[0]
    return dict(spec=spec, ranks=_results(group), single=single, flipped=flipped,
                lr=train_cfg.optimizer.keywords.lr,
                jax=dict(loss=float(j_loss), terms={k: float(v[0]) for k, v in j_terms.items()},
                         grads=bridged(j_grads), flipped=bridged(j_flipped),
                         params=bridged(j_params), stats=bridged(j_stats, 'batch_stats')))


def _norm(grads, ref=None):
    """The f64 norm over all parameters of ``grads`` (minus ``ref``)."""
    return float(sum(torch.linalg.vector_norm(g if ref is None else g - ref[n],
                                              dtype=torch.float64) ** 2
                     for n, g in grads.items())) ** 0.5


def _check_grads(grads, ref, floor_grads, what):
    """``tests/test_torch_stereo_train.py``'s gate: the largest elementwise
    difference at most 8x the floor's (and 5e-2 of the largest gradient),
    the norm-wise difference at most 3x the floor's."""
    assert sorted(grads) == sorted(ref)
    got_abs = max(float((grads[n] - g).abs().max()) for n, g in ref.items())
    floor_abs = max(float((floor_grads[n] - g).abs().max()) for n, g in ref.items())
    gmax = max(float(g.abs().max()) for g in ref.values())
    assert got_abs <= max(8 * floor_abs, 1e-5 * gmax), (what, got_abs, floor_abs, gmax)
    assert got_abs <= 5e-2 * gmax, (what, got_abs, gmax)
    den = _norm(ref)
    got = _norm(grads, ref) / den
    floor = _norm(floor_grads, ref) / den
    assert got <= max(3 * floor, 1e-6), (what, got, floor)


def _check_state(out, ref_params, ref_stats, lr, what):
    worst = max(float((out['params'][n] - v).abs().max()) for n, v in ref_params.items())
    assert worst <= 2.5 * lr, (what, worst, lr)
    for name, value in ref_stats.items():
        if name.endswith('num_batches_tracked'):
            continue
        err = float((out['buffers'][name] - value).abs().max())
        assert err <= 1e-4 * float(value.abs().max()), (what, name, err)


@pytest.mark.parametrize('case', [0, 1], ids=['boxes_everywhere', 'a_half_without_boxes'])
def test_stereo_step_is_the_single_process_step(stereo, case):
    ref, floor = stereo['single'][case], stereo['flipped'][case]
    assert ref['count'] == 1 and ref['metrics']['total'] > 0
    for r, out in enumerate(stereo['ranks']):
        assert out[case]['count'] == 1, r  # no process skipped the update alone
        for name, value in ref['metrics'].items():
            np.testing.assert_allclose(out[case]['metrics'][name], value, rtol=1e-5,
                                       err_msg=f'{r} {name}')
        _check_grads(out[case]['grads'], ref['grads'], floor['grads'], f'rank {r}')
        ref_stats = {n: b for n, b in ref['buffers'].items()}
        _check_state(out[case], ref['params'], ref_stats, stereo['lr'], f'rank {r}')
    a, b = (out[case] for out in stereo['ranks'])
    for n, p in a['params'].items():  # one update on every process
        assert torch.equal(p, b['params'][n]), n


def test_stereo_step_matches_the_jax_data_parallel_step(stereo):
    ref = stereo['jax']
    out = stereo['ranks'][0][0]
    for name, value in ref['terms'].items():
        assert value > 0, name
        np.testing.assert_allclose(out['metrics'][name], value, rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(out['metrics']['total'], ref['loss'], rtol=2e-4)
    _check_grads(out['grads'], ref['grads'], ref['flipped'], 'against JAX')
    _check_state(out, ref['params'], ref['stats'], stereo['lr'], 'against JAX')


# --------------------------------------------------------------------------
# the train CLI in two processes; no group; a group of one
# --------------------------------------------------------------------------

CLI_RUNNER = '''
import sys
import torch
sys.modules['torch.utils.tensorboard'] = None  # its import pulls in TensorFlow
from visualdet3d_tpu_torch.cli import train as train_cli
built = []
real = train_cli.build_system
train_cli.build_system = lambda cfg, device: built.append(real(cfg, device)) or built[-1]
train_cli.main(sys.argv[2:])
torch.save(built[0].net.state_dict(), sys.argv[1])
'''


def test_train_cli_in_two_processes(tmp_path):
    """KM3D (depth-18 ``resnet`` core, 64x256, batch 2 a process) on the
    JAX tests' mini KITTI tree, one epoch of two steps in each process."""
    root = build_mini_kitti(str(tmp_path / 'kitti'))
    split = write_split_files(root, str(tmp_path / 'split'), [0, 1, 2, 3], [2, 3])
    settings = dict(_paths(tmp_path, root, split), **{
        'detector.backbone': {'name': 'resnet', 'depth': 18},
        'data.num_workers': 0,
        'data.train_augmentation.2.keywords.output_w': TINY_HW[1],
        'data.train_augmentation.2.keywords.output_h': TINY_HW[0],
        'data.test_augmentation.1.keywords.size': list(TINY_HW)})
    config = _write_config(tmp_path / 'km3d_tiny.py', 'km3d.py', settings)
    imdb_precompute_3d.main(['--config', config])
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-c', CLI_RUNNER, str(tmp_path / f'net{r}.pt'), '--config', config,
         '--device', 'cpu', '--coordinator', f'127.0.0.1:{port}', '--num_processes', str(WORLD),
         '--process_id', str(r)], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * WORLD, outs
    nets = [torch.load(tmp_path / f'net{r}.pt') for r in range(WORLD)]
    for name, value in nets[0].items():
        assert torch.equal(value, nets[1][name]), name
    assert 'epoch 0:' in outs[0] and 'epoch 0:' not in outs[1]
    assert 'process 0 of 2' in outs[0]
    with open(tmp_path / 'log' / 'train_stats.jsonl') as f:
        [stats] = f.readlines()
    assert '"steps": 2' in stats
    from visualdet3d_tpu_torch.checkpoint import CheckpointManager
    saved = CheckpointManager(str(tmp_path / 'checkpoint')).restore()
    for name, value in nets[0].items():
        assert torch.equal(saved['model'][name], value), name
    initial = DETECTOR_DICT['KM3D'](_cfg_detector(config), device='cpu').net.state_dict()
    assert any(not torch.equal(v, nets[0][k]) for k, v in initial.items()
               if v.is_floating_point())


def _cfg_detector(config):
    from visualdet3d_tpu_torch.config import cfg_from_file
    return cfg_from_file(config).detector


def test_helpers_are_the_identity_without_a_group():
    assert not mesh.is_distributed() and mesh.world_size() == 1 and mesh.rank() == 0
    x = torch.randn(5, 3)
    assert mesh.all_sum(x) is x
    assert torch.equal(mesh.global_mean(x), x.mean())
    p = torch.nn.Parameter(torch.randn(3))
    p.grad = torch.randn(3)
    g = p.grad.clone()
    mesh.average_gradients([p])
    assert torch.equal(p.grad, g)
    m = mesh.make_mesh()
    assert (m.rank, m.size) == (0, 1) and mesh.num_local_batch(8, m) == 8
    assert mesh.shard_batch(m, {'a': x})['a'] is x
    assert mesh.initialize_distributed(device='cpu') == torch.device('cpu')
    for given in (('h:1', None, None), (None, 2, None), (None, None, 0), ('h:1', 2, None)):
        with pytest.raises(ValueError, match='together'):
            mesh.check_process_options(*given)
    with pytest.raises(ValueError, match='not in'):
        mesh.check_process_options('h:1', 2, 2)


def test_a_group_of_one(units):
    """gloo with one process, in this process: the sum and the gradient
    average are bit for bit the identity, the dropout mask is the
    single-process one, and the losses and BatchNorms (now on their global
    paths: the fast variance) equal the single-process ones within f32
    rounding."""
    dev = mesh.initialize_distributed(f'127.0.0.1:{_free_port()}', 1, 0, device='cpu')
    try:
        assert dev == torch.device('cpu') and mesh.is_distributed() and mesh.world_size() == 1
        x = torch.randn(5, 3, requires_grad=True)
        y = mesh.all_sum(x)
        assert torch.equal(y, x)
        y.sum().backward()
        assert torch.equal(x.grad, torch.ones_like(x))
        p = torch.nn.Parameter(torch.randn(3))
        p.grad = torch.randn(3)
        g = p.grad.clone()
        mesh.average_gradients([p])
        assert torch.equal(p.grad, g)
        out = worker.units_case(units['spec'])
    finally:
        mesh.shutdown()
    assert not mesh.is_distributed()
    ref = units['ref']
    assert torch.equal(out['dropout'], ref['dropout'])
    for name, (value, grads) in out['losses'].items():
        np.testing.assert_allclose(float(value), float(ref['losses'][name][0]), rtol=1e-5,
                                   err_msg=name)
        for key, g in grads.items():
            want = ref['losses'][name][1][key]
            assert float((g - want).abs().max()) <= 1e-5 * float(want.abs().max()), (name, key)
    for name in ('bn2d', 'bn3d'):
        for key in ('y', 'dx', 'dw', 'db', 'mean', 'var'):
            want = ref[name][key]
            err = float((out[name][key] - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (name, key, err)
