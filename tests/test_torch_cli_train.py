"""The port's configs, checkpoints, train CLI and KM3D's ``resnet`` core on
the CPU:

* ``cfg_from_file`` on every ``configs/*.py`` in a fresh interpreter: each
  config builds the port's ``EasyDict`` (arrays stay numpy) and no module
  of the JAX package is loaded afterwards;
* a checkpoint round trip (network, Adam state, scheduler, step) bit for
  bit, ``max_to_keep``, and the backbone warm start;
* ``python -m visualdet3d_tpu_torch.cli.train`` on ``--device cpu``: KM3D
  with a depth-18 ``resnet`` core at 64x256 on the JAX tests' mini KITTI
  tree (imdb precompute, one epoch, then ``--resume`` to a second: the
  restored state equal to the saved one, the epoch's steps, the
  scheduler's units in steps as ``tests/test_cli_train_eval.py`` checks
  for JAX), Stereo3D at depth 18 through the disparity precompute,
  ``configs/monodepth.py`` at depth 18 and 64x128 on a synthetic KITTI
  depth tree (``cli.depth_precompute``, one epoch, ``evaluate_kitti_depth``
  after it), and the start-up raises (an evaluation that is not registered;
  the multi-process options);
* KM3D on the ``resnet`` core against the JAX package: the f32 raw outputs
  (rtol 1e-4, atol 1e-4 of each map's std, as ``test_torch_km3d.py``) and
  the training loss's terms (rtol 2e-4, the bound of the whole-step test in
  ``test_torch_km3d_train.py``).
"""
import copy
import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import visualdet3d_tpu.models.detectors.km3d  # noqa: F401
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS

import visualdet3d_tpu_torch.models  # noqa: F401
from visualdet3d_tpu_torch import checkpoint, testing
from visualdet3d_tpu_torch.cli import disparity_compute, imdb_precompute_3d
from visualdet3d_tpu_torch.cli import train as train_cli
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.pipelines.train_state import TrainState
from visualdet3d_tpu_torch.registry import DETECTOR_DICT
from visualdet3d_tpu_torch.solver import optimizers

from kitti_fixture import build_mini_kitti, write_split_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, 'configs', '*.py')))
TINY_HW = (64, 256)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (the tier-1 run
    puts six workers on one machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------- configs

LOAD_CONFIGS = '''
import json, sys
from visualdet3d_tpu_torch.config import EasyDict, cfg_from_file
out = {}
for path in sys.argv[1:]:
    cfg = cfg_from_file(path)
    anchors = cfg.detector.get('anchors', {})
    out[path] = dict(
        types=sorted({type(cfg).__name__ + '.' + type(cfg).__module__,
                      type(cfg.data).__module__, type(cfg.detector).__module__,
                      type(cfg.data.train_augmentation[0]).__module__}),
        ratios=type(anchors.get('ratios')).__name__ if anchors else None,
        rgb_mean=type(cfg.data.augmentation.rgb_mean).__name__,
        name=cfg.detector.name)
out['jax_modules'] = sorted(m for m in sys.modules if m.startswith('visualdet3d_tpu')
                            and not m.startswith('visualdet3d_tpu_torch'))
out['jax'] = 'jax' in sys.modules
print(json.dumps(out))
'''


@pytest.fixture(scope='module')
def loaded_configs(tmp_path_factory):
    env = dict(os.environ, VD3D_WORKDIR=str(tmp_path_factory.mktemp('workdirs')),
               PYTHONPATH=ROOT)
    paths = [os.path.join(ROOT, 'configs', name) for name in CONFIGS]
    proc = subprocess.run([sys.executable, '-c', LOAD_CONFIGS, *paths], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('config', CONFIGS)
def test_cfg_from_file_builds_the_ports_easydict(loaded_configs, config):
    got = loaded_configs[os.path.join(ROOT, 'configs', config)]
    assert got['types'] == ['EasyDict.visualdet3d_tpu_torch.config', 'visualdet3d_tpu_torch.config']
    assert got['rgb_mean'] == 'ndarray'
    if got['ratios'] is not None:
        assert got['ratios'] == 'ndarray'
    assert got['name']


def test_cfg_from_file_leaves_no_jax_package_module(loaded_configs):
    assert loaded_configs['jax_modules'] == []
    assert not loaded_configs['jax']


def test_cfg_from_file_restores_the_jax_package_in_a_process_that_has_it(tmp_path):
    """Here the JAX package is imported: the name is bound to it again
    after the run, and a config importing any other JAX module fails."""
    import visualdet3d_tpu.config as jax_config
    from visualdet3d_tpu_torch.config import cfg_from_file
    good = tmp_path / 'good.py'
    good.write_text('from visualdet3d_tpu.config import EasyDict as edict\ncfg = edict(a={"b": 1})\n')
    cfg = cfg_from_file(str(good))
    assert type(cfg).__module__ == 'visualdet3d_tpu_torch.config' and cfg.a.b == 1
    assert sys.modules['visualdet3d_tpu.config'] is jax_config
    bad = tmp_path / 'bad.py'
    bad.write_text('from visualdet3d_tpu.geometry import calc_iou\ncfg = {}\n')
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == 'visualdet3d_tpu.geometry'}
    try:
        with pytest.raises(ImportError):
            cfg_from_file(str(bad))
    finally:
        sys.modules.update(saved)
    assert sys.modules['visualdet3d_tpu.config'] is jax_config


# ------------------------------------------------------------- checkpoints


def _small_training(seed: int):
    """A conv + BN net with Adam (MultiStepLR) after three updates."""
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4),
                              torch.nn.Conv2d(4, 2, 1))
    state = TrainState(optimizers.build_optimizer(
        net.parameters(), EasyDict(type_name='adam', keywords=dict(lr=1e-3)),
        EasyDict(type_name='MultiStepLR', keywords=dict(milestones=[1], gamma=0.5)),
        steps_per_unit=2))
    for _ in range(3):
        state.optimizer.zero_grad()
        net(torch.randn(2, 3, 8, 8)).square().mean().backward()
        state.optimizer.step()
        state.step += 1
    return net, state


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    net, state = _small_training(0)
    manager = checkpoint.CheckpointManager(str(tmp_path))
    assert manager.restore() is None and manager.latest_step() is None
    manager.save(state.step, checkpoint.train_state_dict(net, state))
    assert os.listdir(tmp_path) == ['checkpoint_3.pt']  # no temporary file left
    other_net, other_state = _small_training(1)
    checkpoint.load_train_state(other_net, other_state, manager.restore())
    _assert_tree_equal(other_net.state_dict(), net.state_dict())
    _assert_tree_equal(other_state.optimizer.torch_optimizer.state_dict(),
                       state.optimizer.torch_optimizer.state_dict())
    assert other_state.optimizer.count == state.optimizer.count == 3
    assert other_state.step == 3
    assert other_state.optimizer.schedule(other_state.optimizer.count) == 5e-4


def test_checkpoint_keeps_the_last_five(tmp_path):
    manager = checkpoint.CheckpointManager(str(tmp_path))
    for step in (2, 4, 6, 8, 10, 12, 14):
        manager.save(step, {'x': torch.tensor(step)})
    assert manager.all_steps() == [6, 8, 10, 12, 14]
    assert manager.latest_step() == 14
    assert int(manager.restore()['x']) == 14 and manager.restore(8)['step'] == 8


def test_merge_pretrained_backbone(tmp_path):
    cfg = testing.km3d_detector_cfg(head_features=16)
    cfg.backbone = EasyDict(name='resnet', depth=18)
    system = DETECTOR_DICT['KM3D'](cfg, device='cpu')
    trunk = system.net.KM3DCore_0.ResNet_0
    pretrained = {k: torch.randn_like(v) if v.is_floating_point() else v
                  for k, v in trunk.state_dict().items()}
    torch.save(pretrained, tmp_path / 'resnet18.pt')
    head_before = system.net.KM3DHeadNet_0.state_dict()
    loaded = checkpoint.merge_pretrained_backbone(system.net, str(tmp_path / 'resnet18.pt'))
    assert len(loaded) == len(pretrained)
    _assert_tree_equal(trunk.state_dict(), pretrained)
    _assert_tree_equal(system.net.KM3DHeadNet_0.state_dict(), head_before)
    pretrained['conv1.weight'] = torch.zeros(3)
    torch.save(pretrained, tmp_path / 'bad.pt')
    with pytest.raises(ValueError, match='conv1.weight'):
        checkpoint.merge_pretrained_backbone(system.net, str(tmp_path / 'bad.pt'))


# --------------------------------------------------------------- train CLI

CONFIG_FILE = '''
import json
from visualdet3d_tpu_torch.config import cfg_from_file
cfg = cfg_from_file({base!r})
with open({settings!r}) as f:
    settings = json.load(f)
for dotted, value in settings.items():
    node = cfg
    *parents, leaf = dotted.split('.')
    for key in parents:
        node = node[int(key) if key.isdigit() else key]
    node[int(leaf) if leaf.isdigit() else leaf] = value
'''


def _write_config(path, base: str, settings: dict) -> str:
    """A config file that loads ``configs/<base>`` and sets the dotted
    keys of ``settings`` (kept beside it as JSON, so a test can change
    them between runs)."""
    settings_path = str(path) + '.json'
    with open(settings_path, 'w') as f:
        json.dump(settings, f)
    path.write_text(CONFIG_FILE.format(base=os.path.join(ROOT, 'configs', base),
                                       settings=settings_path))
    return str(path)


def _set(config_path: str, **changes) -> None:
    with open(config_path + '.json') as f:
        settings = json.load(f)
    settings.update({k.replace('__', '.'): v for k, v in changes.items()})
    with open(config_path + '.json', 'w') as f:
        json.dump(settings, f)


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    root = build_mini_kitti(str(tmp_path_factory.mktemp('kitti')))
    split = write_split_files(root, str(tmp_path_factory.mktemp('split')), [0, 1, 2, 3], [2, 3])
    return root, split


def _paths(work, root, split):
    return {'path.data_path': root, 'path.preprocessed_path': str(work / 'output'),
            'path.log_path': str(work / 'log'), 'path.checkpoint_path': str(work / 'checkpoint'),
            'data.train_split_file': split[0], 'data.val_split_file': split[1],
            'data.batch_size': 2, 'data.num_workers': 2, 'data.rgb_shape': [*TINY_HW, 3],
            'trainer.max_epochs': 1, 'trainer.test_iter': 0, 'trainer.disp_iter': 1}


@pytest.fixture(scope='module')
def km3d_run(mini, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, 'torch.utils.tensorboard', None)
        yield _km3d_run(mini, tmp_path_factory)


def _km3d_run(mini, tmp_path_factory):
    """The tiny KM3D config: precompute, then one epoch on the CPU (the
    scheduler's ``steps_per_unit`` recorded)."""
    work = tmp_path_factory.mktemp('km3d')
    settings = dict(_paths(work, *mini), **{
        'detector.backbone': {'name': 'resnet', 'depth': 18},
        'data.train_augmentation.2.keywords.output_w': TINY_HW[1],
        'data.train_augmentation.2.keywords.output_h': TINY_HW[0],
        'data.test_augmentation.1.keywords.size': list(TINY_HW)})
    config = _write_config(work / 'km3d_tiny.py', 'km3d.py', settings)
    imdb_precompute_3d.main(['--config', config])
    seen = []
    real = optimizers.build_optimizer

    def spy(*args, **kwargs):
        seen.append(kwargs['steps_per_unit'])
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optimizers, 'build_optimizer', spy)
        train_cli.main(['--config', config, '--device', 'cpu'])
    return config, work, seen


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The metric writer's JSON-lines path, the one the card takes (it has
    no tensorboard package; importing it here costs ~18 s)."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)


def _stats(work):
    with open(work / 'log' / 'train_stats.jsonl') as f:
        return [json.loads(line) for line in f]


def test_cli_trains_an_epoch_and_checkpoints(km3d_run):
    config, work, seen = km3d_run
    assert seen == [2]  # epoch units converted to steps: 4 images // batch 2
    manager = checkpoint.CheckpointManager(str(work / 'checkpoint'))
    assert manager.all_steps() == [2]
    saved = manager.restore()
    assert saved['step'] == 2 and saved['scheduler'] == {'count': 2}
    [stats] = _stats(work)
    assert stats['steps'] == 2 and stats['global_step'] == 2
    assert np.isfinite(stats['loss']) and stats['launches'] == {}  # CPU: the plain paths
    assert stats['loader_wait_s'] >= 0 and stats['copy_device_ms'] is None
    with open(work / 'log' / 'metrics.jsonl') as f:
        scalars = [json.loads(line) for line in f if '"value"' in line]
    assert [r['step'] for r in scalars if r['name'] == 'total/train'] == [1, 2]


def test_cli_resumes_from_the_saved_state(km3d_run, monkeypatch, capsys):
    config, work, _ = km3d_run
    saved = checkpoint.CheckpointManager(str(work / 'checkpoint')).restore(2)
    restored = {}
    real = checkpoint.load_train_state

    def spy(net, state, ckpt):
        real(net, state, ckpt)
        restored.update(model={k: v.clone() for k, v in net.state_dict().items()},
                        optimizer=copy.deepcopy(state.optimizer.torch_optimizer.state_dict()),
                        count=state.optimizer.count, step=state.step)

    monkeypatch.setattr(checkpoint, 'load_train_state', spy)
    _set(config, trainer__max_epochs=2)
    train_cli.main(['--config', config, '--device', 'cpu', '--resume'])
    assert 'resumed from step 2 (epoch 1)' in capsys.readouterr().out
    _assert_tree_equal(restored['model'], saved['model'])
    _assert_tree_equal(restored['optimizer'], saved['optimizer'])
    assert restored['count'] == 2 and restored['step'] == 2
    assert checkpoint.CheckpointManager(str(work / 'checkpoint')).all_steps() == [2, 4]
    assert [s['epoch'] for s in _stats(work)] == [0, 1]
    _set(config, trainer__max_epochs=1)


def test_cli_iteration_based_schedule_keeps_its_units(km3d_run, monkeypatch):
    config, _, _ = km3d_run
    seen = []
    real = optimizers.build_optimizer
    monkeypatch.setattr(optimizers, 'build_optimizer',
                        lambda *a, **k: seen.append(k['steps_per_unit']) or real(*a, **k))
    _set(config, scheduler__is_iter_based=True, trainer__max_epochs=0)
    try:
        train_cli.main(['--config', config, '--device', 'cpu'])
    finally:
        _set(config, scheduler__is_iter_based=False, trainer__max_epochs=1)
    assert seen == [1]


def test_cli_warm_starts_the_backbone(km3d_run, tmp_path, capsys):
    config, _, _ = km3d_run
    cfg = testing.km3d_detector_cfg(head_features=16)
    cfg.backbone = EasyDict(name='resnet', depth=18)
    trunk = DETECTOR_DICT['KM3D'](cfg, device='cpu').net.KM3DCore_0.ResNet_0
    torch.save(trunk.state_dict(), tmp_path / 'trunk.pt')
    _set(config, trainer__max_epochs=0)
    try:
        train_cli.main(['--config', config, '--device', 'cpu',
                        '--pretrained_backbone', str(tmp_path / 'trunk.pt')])
    finally:
        _set(config, trainer__max_epochs=1)
    assert f'warm-started backbone from {tmp_path / "trunk.pt"}' in capsys.readouterr().out


def test_cli_refuses_an_evaluation_it_cannot_run(km3d_run):
    """An evaluator that is not registered within ``max_epochs``: a raise
    at start, naming the registered ones. ``evaluate_kitti_obj`` runs
    (``tests/test_torch_cli_eval.py``), ``evaluate_kitti_depth`` too
    (:func:`test_cli_trains_and_evaluates_monodepth`)."""
    config, _, _ = km3d_run
    _set(config, trainer__test_iter=1, trainer__evaluate_func='evaluate_kitti_tracking')
    try:
        with pytest.raises(NotImplementedError,
                           match="'evaluate_kitti_tracking' after epochs.*evaluate_kitti_depth"):
            train_cli.main(['--config', config, '--device', 'cpu'])
    finally:
        _set(config, trainer__test_iter=0, trainer__evaluate_func='evaluate_kitti_obj')
    trainer = EasyDict(max_epochs=20, test_iter=10)
    assert train_cli.evaluation_epochs(trainer, 0) == [9, 19]
    assert train_cli.evaluation_epochs(trainer, 19) == [19]
    assert train_cli.evaluation_epochs(EasyDict(max_epochs=9, test_iter=10), 0) == []


DEPTH_TREE_HW = (80, 160)
DEPTH_HW = (64, 128)


def monodepth_settings(work, tree) -> dict:
    """``configs/monodepth.py`` cut to ResNet-18 at 64x128 (the crops of the
    80x160 tree), batch 2, one epoch, on the synthetic depth tree ``tree``
    (``testing.write_synthetic_kitti_depth``)."""
    return {
        'path.raw_path': tree['raw_path'], 'path.depth_path': tree['depth_path'],
        'path.validation_path': tree['validation_path'],
        'path.preprocessed_path': str(work / 'output'), 'path.log_path': str(work / 'log'),
        'path.checkpoint_path': str(work / 'checkpoint'),
        'detector.preprocessed_path': str(work / 'output'), 'detector.backbone.depth': 18,
        'data.batch_size': 2, 'data.num_workers': 2, 'data.rgb_shape': [*DEPTH_HW, 3],
        'data.train_augmentation.2.keywords.output_height': DEPTH_HW[0],
        'data.train_augmentation.3.keywords.width': DEPTH_HW[1],
        'data.test_augmentation.1.keywords.output_height': DEPTH_HW[0],
        'data.test_augmentation.2.keywords.output_width': DEPTH_HW[1],
        'trainer.max_epochs': 1, 'trainer.test_iter': 1, 'trainer.disp_iter': 1}


def test_cli_trains_and_evaluates_monodepth(tmp_path, capsys):
    """``configs/monodepth.py`` through the CLIs on the CPU: the depth
    prior precompute, then one epoch (2 steps of 2 images) with
    ``evaluate_kitti_depth`` after it: a finite loss, the checkpoint, a
    16-bit PNG a validation frame at the original size, the nine depth
    metrics printed and the evaluation's line in ``eval_stats.jsonl``."""
    from visualdet3d_tpu_torch.cli import depth_precompute
    from visualdet3d_tpu_torch.data.image_io import read_png
    tree = testing.write_synthetic_kitti_depth(str(tmp_path / 'tree'), 4, seed=6, n_val=2,
                                               image_hw=DEPTH_TREE_HW)
    config = _write_config(tmp_path / 'monodepth_tiny.py', 'monodepth.py',
                           monodepth_settings(tmp_path, tree))
    depth_precompute.main(['--config', config])
    assert (tmp_path / 'output' / 'training' / 'log_depth_sum.npy').is_file()
    train_cli.main(['--config', config, '--device', 'cpu'])
    out = capsys.readouterr().out
    [stats] = _stats(tmp_path)
    assert stats['steps'] == 2 and np.isfinite(stats['loss']) and stats['loss'] > 0
    assert checkpoint.CheckpointManager(str(tmp_path / 'checkpoint')).all_steps() == [2]
    pngs = sorted((tmp_path / 'output' / 'validation' / 'data').iterdir())
    assert [p.name for p in pngs] == ['0000000000.png', '0000000001.png']
    for p in pngs:
        depth = read_png(str(p))
        assert depth.dtype == np.uint16 and depth.shape == DEPTH_TREE_HW and depth.min() >= 1
    assert out.count('mean ') == 9 and 'mean rmse' in out
    with open(tmp_path / 'log' / 'eval_stats.jsonl') as f:
        [eval_stats] = [json.loads(line) for line in f]
    assert eval_stats['frames'] == 2 and len(eval_stats['write_ms']) == 2


@pytest.mark.parametrize('flag', [['--coordinator', 'localhost:1234'],
                                  ['--num_processes', '2'], ['--process_id', '0']])
def test_cli_refuses_the_multi_process_options(km3d_run, flag):
    """The three multi-process options come together or not at all: one
    alone raises before anything is built."""
    config, _, _ = km3d_run
    with pytest.raises(ValueError, match='--num_processes N and --process_id i together'):
        train_cli.main(['--config', config, '--device', 'cpu', *flag])


def test_cli_trains_stereo_through_the_disparity_precompute(mini, tmp_path):
    """Stereo3D (depth 18, 64x256): imdb and priors, the disparity maps,
    then an epoch of ``train_stereo_detection`` with the disparity loss."""
    settings = dict(_paths(tmp_path, *mini), **{
        'detector.backbone.depth': 18,
        'detector.head.preprocessed_path': str(tmp_path / 'output'),
        'data.train_augmentation.3.keywords.size': list(TINY_HW),
        'data.test_augmentation.2.keywords.size': list(TINY_HW)})
    config = _write_config(tmp_path / 'stereo_tiny.py', 'stereo3d.py', settings)
    imdb_precompute_3d.main(['--config', config])
    disparity_compute.main(['--config', config])
    disp = sorted(os.listdir(tmp_path / 'output' / 'training' / 'disp'))
    assert disp == sorted(f'{p}{i:06d}.png' for p in ('P2', 'P3') for i in range(4))
    train_cli.main(['--config', config, '--device', 'cpu', '--max_objects', '8'])
    [stats] = _stats(tmp_path)
    assert stats['steps'] == 2 and np.isfinite(stats['loss'])
    saved = checkpoint.CheckpointManager(str(tmp_path / 'checkpoint')).restore()
    assert any('CostVolumePyramid_0.Conv_2' in k for k in saved['model'])  # the disparity head


# ------------------------------------------------------- KM3D resnet core

IMAGE_HW = (64, 256)
BATCH = 2


def _to_dict(tree):
    if hasattr(tree, 'items'):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope='module')
def resnet_pair():
    """JAX's and the port's KM3D on a depth-18 ``resnet`` core with the same
    weights (JAX's init through the bridge; the head's output convs
    calibrated on the port's side and copied back, so that the maps are not
    constant)."""
    cfg = testing.km3d_detector_cfg(head_features=16, top_k=20)
    cfg.backbone = EasyDict(name='resnet', depth=18)
    jsys = JAX_DETECTORS['KM3D'](EasyDict(copy.deepcopy(cfg)))
    variables = _to_dict(jax.jit(lambda key: jsys.init(key, IMAGE_HW))(jax.random.PRNGKey(0)))
    tsys = DETECTOR_DICT['KM3D'](EasyDict(copy.deepcopy(cfg)), device='cpu')
    skipped = tsys.load_flax_variables(variables)
    images = np.random.default_rng(0).standard_normal((BATCH, *IMAGE_HW, 3)).astype(np.float32)
    testing.calibrate_head_convs(tsys, torch.from_numpy(images), torch.Generator().manual_seed(1))
    for name, m in tsys.net.named_modules():
        if name.startswith('KM3DHeadNet_0.') and name.endswith('_out'):
            node = variables['params']
            for part in name.split('.'):
                node = node[part]
            node['kernel'] = m.weight.detach().permute(2, 3, 1, 0).contiguous().numpy()
            node['bias'] = m.bias.detach().numpy().copy()
    return jsys, variables, tsys, skipped, images


def test_resnet_core_loads_through_the_bridge(resnet_pair):
    _, variables, tsys, skipped, _ = resnet_pair
    assert skipped == []
    core = variables['params']['KM3DNet_0']['KM3DCore_0'] if 'KM3DNet_0' in variables['params'] \
        else variables['params']['KM3DCore_0']
    assert sorted(k for k in core if not k.startswith('ResNet')) == [
        'BatchNorm_0', 'BatchNorm_1', 'BatchNorm_2', 'Conv_0', 'Conv_1', 'Conv_2']
    assert tsys.net.KM3DCore_0.out_channels == 256


def test_resnet_core_raw_outputs_match_jax_f32(resnet_pair):
    jsys, variables, tsys, _, images = resnet_pair
    ref = jax.jit(lambda v, im: jsys.net.apply(v, im, train=False))(variables, images)
    out = tsys.predict_raw(torch.from_numpy(images))
    assert sorted(out) == sorted(ref)
    for name in ref:
        r = np.asarray(ref[name])
        assert out[name].shape == r.shape == (BATCH, IMAGE_HW[0] // 4, IMAGE_HW[1] // 4,
                                              dict(tsys.head_dict)[name])
        assert r.std() > 0, name
        np.testing.assert_allclose(out[name].numpy(), r, rtol=1e-4, atol=1e-4 * r.std(),
                                   err_msg=name)


def test_resnet_core_training_loss_matches_jax(resnet_pair):
    jsys, variables, tsys, _, _ = resnet_pair
    batch = testing.km3d_training_batch(np.random.default_rng(3), BATCH, IMAGE_HW)
    (ref_total, ref_terms), _ = jax.jit(
        lambda v, im, g, p: jsys.loss(v, im, g, p, train=True, epoch=10.0))(
        variables, batch['images'], batch['gts'], batch['P2'])
    state = {k: v.clone() for k, v in tsys.net.state_dict().items()}
    try:
        total, terms = tsys.loss(torch.from_numpy(batch['images']),
                                 {k: torch.from_numpy(v) for k, v in batch['gts'].items()},
                                 torch.from_numpy(batch['P2']), epoch=10.0)
    finally:
        tsys.net.load_state_dict(state)  # the train-mode forward moved the running statistics
    assert sorted(terms) == sorted(ref_terms)
    for name in ref_terms:
        np.testing.assert_allclose(float(terms[name].detach()), float(ref_terms[name]),
                                   rtol=2e-4, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=2e-4)
