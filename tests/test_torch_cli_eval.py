"""The port's evaluation path end to end on the CPU, on the JAX tests' mini
KITTI tree (tiny configs: depth-18 trunks at 64x256):

* the train CLI evaluates after its epoch at ``test_iter=1`` (KM3D): the
  AP table printed, a result txt a validation frame, the evaluation's line
  in ``eval_stats.jsonl``;
* ``python -m visualdet3d_tpu_torch.cli.eval`` on that checkpoint: a txt a
  frame, the table, its stats line;
* ``cli.quantize`` then ``cli.eval --quantized_path`` on a Stereo3D int8
  config (``configs/stereo3d_int8.py``) writes the same result files, byte
  for byte, as the eval that calibrates on the fly, with detections in
  them; calibration leaves the caller's numpy generator as it was;
* the eval CLI on ``configs/monodepth.py`` (depth 18, 64x128) from the
  train CLI's checkpoint on a synthetic KITTI depth tree: a 16-bit PNG a
  frame, the depth metrics, equal to the evaluation the train CLI ran on
  the same weights;
* the refusals: ``--quantized_path`` with an f32 config, an evaluation
  that is not registered in the eval and train CLIs, int8 of a mono
  detector; a checkpoint that does not fit the network;
* ``checkpoint.save_params`` / ``load_params`` round trip.

The int8 round trip compares the port with itself (no XLA int8 conv here).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import visualdet3d_tpu_torch.models  # noqa: F401
from visualdet3d_tpu_torch import checkpoint, testing
from visualdet3d_tpu_torch.cli import disparity_compute, imdb_precompute_3d
from visualdet3d_tpu_torch.cli import eval as eval_cli
from visualdet3d_tpu_torch.cli import quantize as quantize_cli
from visualdet3d_tpu_torch.cli import train as train_cli
from visualdet3d_tpu_torch.config import cfg_from_file
from visualdet3d_tpu_torch.pipelines import inference_prep
from visualdet3d_tpu_torch.registry import DATASET_DICT, DETECTOR_DICT

from kitti_fixture import build_mini_kitti, write_split_files
from test_torch_cli_train import TINY_HW, _paths, _set, _write_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (the tier-1 run
    puts six workers on one machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The metric writer's JSON-lines path (importing tensorboard here
    costs ~18 s)."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    root = build_mini_kitti(str(tmp_path_factory.mktemp('kitti')))
    split = write_split_files(root, str(tmp_path_factory.mktemp('split')), [0, 1, 2, 3], [2, 3])
    return root, split


def _ap_table(text: str):
    """The AP rows of a report: {(class, overlaps, metric): [easy, moderate, hard]}."""
    table, head = {}, None
    for line in text.splitlines():
        if 'AP(Average Precision)@' in line:
            head = line.split(':')[0]
        elif head and 'AP:' in line:
            metric, values = line.split('AP:')
            table[(head, metric.strip())] = [float(v) for v in values.split(',')]
    return table


def _check_table(text: str, n_classes: int):
    """Each class's two overlap settings with bbox, BEV and 3D rows (and
    AOS where the results carry alphas), every AP finite."""
    table = _ap_table(text)
    assert len(table) in (6 * n_classes, 8 * n_classes), sorted(table)
    assert all(len(v) == 3 and np.isfinite(v).all() for v in table.values())
    return table


def _eval_stats(work):
    with open(work / 'log' / 'eval_stats.jsonl') as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def km3d_trained(mini, tmp_path_factory):
    """The tiny KM3D config (``resnet`` depth 18, 64x256): precompute, then
    one epoch of the train CLI with ``test_iter=1`` (it evaluates the
    validation split after the epoch); returns (config, work dir, output)."""
    work = tmp_path_factory.mktemp('km3d')
    settings = dict(_paths(work, *mini), **{
        'detector.backbone': {'name': 'resnet', 'depth': 18},
        'data.train_augmentation.2.keywords.output_w': TINY_HW[1],
        'data.train_augmentation.2.keywords.output_h': TINY_HW[0],
        'data.test_augmentation.1.keywords.size': list(TINY_HW),
        'trainer.test_iter': 1})
    config = _write_config(work / 'km3d_tiny.py', 'km3d.py', settings)
    imdb_precompute_3d.main(['--config', config])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, 'torch.utils.tensorboard', None)
        out = _capture(lambda: train_cli.main(['--config', config, '--device', 'cpu']))
    return config, work, out


def _capture(fn):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _result_files(work, split='validation'):
    d = work / 'output' / split / 'data'
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


def test_train_cli_evaluates_after_its_epoch(km3d_trained):
    _, work, out = km3d_trained
    assert '/**** start testing after training epoch 0 ******/' in out
    _check_table(out, 1)
    assert sorted(_result_files(work)) == ['000000.txt', '000001.txt']
    [stats] = _eval_stats(work)
    assert stats['epoch'] == 0 and stats['frames'] == 2 and stats['inference_dtype'] == 'float32'
    assert len(stats['frame_ms']) == 2 and stats['evaluator_s'] > 0
    assert checkpoint.CheckpointManager(str(work / 'checkpoint')).all_steps() == [2]


def test_eval_cli_writes_a_result_a_frame_and_the_table(km3d_trained, capsys):
    config, work, _ = km3d_trained
    eval_cli.main(['--config', config, '--checkpoint_path', str(work / 'checkpoint'),
                   '--device', 'cpu'])
    out = capsys.readouterr().out
    _check_table(out, 1)
    assert out.rstrip().endswith('finish')
    assert sorted(_result_files(work)) == ['000000.txt', '000001.txt']
    stats = _eval_stats(work)[-1]
    assert 'epoch' not in stats and stats['split'] == 'validation' and stats['launches'] == {}


def test_bf16_evaluation_folds_km3d_first(km3d_trained, capsys):
    """``inference_dtype='bfloat16'`` folds BN in f32 first (KM3D's fold
    takes its example inputs from ``_net_inputs``): the folded network's
    f32 maps stay within 1e-4 of the unfolded ones (relative to each
    map's largest value), then the eval CLI runs in bf16."""
    config, work, _ = km3d_trained
    cfg = cfg_from_file(config)
    system = eval_cli.load_system(cfg, str(work / 'checkpoint'), torch.device('cpu'))
    images = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (1, *TINY_HW, 3)).astype(np.float32))
    before = system.predict_raw(images)
    cfg.detector.inference_dtype = 'bfloat16'
    inference_prep.prepare_inference_variables(cfg, system)
    cfg.detector.inference_dtype = 'float32'
    after = system.predict_raw(images)
    for k, v in before.items():
        assert float((after[k] - v).abs().max()) <= 1e-4 * float(v.abs().max()), k
    _set(config, detector__inference_dtype='bfloat16')
    try:
        eval_cli.main(['--config', config, '--checkpoint_path', str(work / 'checkpoint'),
                       '--device', 'cpu'])
    finally:
        _set(config, detector__inference_dtype='float32')
    _check_table(capsys.readouterr().out, 1)
    assert _eval_stats(work)[-1]['inference_dtype'] == 'bfloat16'


def test_eval_cli_refuses_a_quantized_path_without_int8(km3d_trained, tmp_path):
    config, work, _ = km3d_trained
    with pytest.raises(ValueError, match="inference_dtype is 'float32'"):
        eval_cli.main(['--config', config, '--checkpoint_path', str(work / 'checkpoint'),
                       '--device', 'cpu', '--quantized_path', str(tmp_path / 'int8.pt')])


def test_int8_of_a_mono_detector_raises(km3d_trained):
    config, work, _ = km3d_trained
    cfg = cfg_from_file(config)
    cfg.detector.inference_dtype = 'int8'
    system = eval_cli.load_system(cfg, str(work / 'checkpoint'), torch.device('cpu'))
    with pytest.raises(NotImplementedError, match='A5 item 5'):
        inference_prep.prepare_inference_variables(cfg, system)


def test_a_checkpoint_that_does_not_fit_raises(km3d_trained):
    config, work, _ = km3d_trained
    cfg = cfg_from_file(config)
    saved = checkpoint.CheckpointManager(str(work / 'checkpoint')).restore()
    system = DETECTOR_DICT[cfg.detector.name](cfg.detector, device='cpu')
    model = dict(saved['model'])
    model.pop(next(iter(model)))
    with pytest.raises(KeyError, match='missing'):
        checkpoint.load_model_weights(system.net, model)
    model = dict(saved['model'], extra=torch.zeros(1))
    with pytest.raises(KeyError, match="unexpected \\['extra'\\]"):
        checkpoint.load_model_weights(system.net, model)


def test_an_evaluation_the_port_lacks_raises(km3d_trained):
    """An ``evaluate_func`` that is not registered: the eval CLI raises
    before building anything, and the train CLI raises at start."""
    config, work, _ = km3d_trained
    _set(config, trainer__evaluate_func='evaluate_kitti_tracking')
    try:
        with pytest.raises(KeyError, match='evaluate_kitti_tracking'):
            eval_cli.main(['--config', config, '--checkpoint_path', str(work / 'checkpoint'),
                           '--device', 'cpu'])
        with pytest.raises(NotImplementedError, match="'evaluate_kitti_tracking' after epochs"):
            train_cli.main(['--config', config, '--device', 'cpu'])
    finally:
        _set(config, trainer__evaluate_func='evaluate_kitti_obj')


def test_eval_cli_evaluates_monodepth(tmp_path, capsys):
    """``python -m visualdet3d_tpu_torch.cli.eval`` on ``configs/monodepth.py``
    (depth 18, 64x128) from the train CLI's checkpoint of one epoch, which
    evaluated after it: the same PNGs bit for bit and the same nine
    metrics; the eval's line in ``eval_stats.jsonl``."""
    from test_torch_cli_train import DEPTH_TREE_HW, monodepth_settings
    from visualdet3d_tpu_torch.data.image_io import read_png
    tree = testing.write_synthetic_kitti_depth(str(tmp_path / 'tree'), 4, seed=7, n_val=2,
                                               image_hw=DEPTH_TREE_HW)
    config = _write_config(tmp_path / 'monodepth_tiny.py', 'monodepth.py',
                           monodepth_settings(tmp_path, tree))
    train_cli.main(['--config', config, '--device', 'cpu'])
    after_training = capsys.readouterr().out
    data = tmp_path / 'output' / 'validation' / 'data'
    trained = {p.name: read_png(str(p)) for p in sorted(data.iterdir())}
    eval_cli.main(['--config', config, '--checkpoint_path', str(tmp_path / 'checkpoint'),
                   '--device', 'cpu'])
    out = capsys.readouterr().out
    assert sorted(trained) == sorted(os.listdir(data)) == ['0000000000.png', '0000000001.png']
    for name, depth in trained.items():
        np.testing.assert_array_equal(read_png(str(data / name)), depth)
    metrics = [line for line in out.splitlines() if line.startswith('mean ')]
    assert len(metrics) == 9 and metrics == [line for line in after_training.splitlines()
                                             if line.startswith('mean ')]
    stats = _eval_stats(tmp_path)
    assert stats[-1]['split'] == 'validation' and stats[-1]['frames'] == 2
    assert stats[-1]['evaluator_s'] > 0 and len(stats[-1]['frame_ms']) == 2


def test_save_params_round_trip(tmp_path):
    params = {'model': {'a.weight': torch.randn(3, 2)},
              'quant': {'A_0/Conv_0': {'kernel_q': torch.ones(2, dtype=torch.int8)}}}
    path = checkpoint.save_params(str(tmp_path / 'sub' / 'artifact.pt'), params)
    assert os.listdir(tmp_path / 'sub') == ['artifact.pt']  # no temporary file left
    back = checkpoint.load_params(path)
    assert torch.equal(back['model']['a.weight'], params['model']['a.weight'])
    assert torch.equal(back['quant']['A_0/Conv_0']['kernel_q'],
                       params['quant']['A_0/Conv_0']['kernel_q'])


# ------------------------------------------------------ the int8 round trip

@pytest.fixture(scope='module')
def stereo_int8(mini, tmp_path_factory):
    """``configs/stereo3d_int8.py`` at depth 18, 64x256, with 32- and
    64-wide head towers, on the mini tree:
    the imdb and disparity precompute, the anchor priors replaced by
    ``testing.write_synthetic_priors`` (four frames fill no prior bin, and
    the decode drops the anchors of empty bins), and a checkpoint of a
    seeded inference system whose prediction convs are calibrated on the
    two validation frames (the class logits shifted so that a twentieth of
    the anchors score above sigmoid(1.5))."""
    work = tmp_path_factory.mktemp('stereo')
    settings = dict(_paths(work, *mini), **{
        'detector.backbone.depth': 18,
        'detector.head.layer_cfg.cls_feature_size': 32,
        'detector.head.layer_cfg.reg_feature_size': 64,
        'detector.head.preprocessed_path': str(work / 'output'),
        'data.train_augmentation.3.keywords.size': list(TINY_HW),
        'data.test_augmentation.2.keywords.size': list(TINY_HW)})
    config = _write_config(work / 'stereo_int8_tiny.py', 'stereo3d_int8.py', settings)
    imdb_precompute_3d.main(['--config', config])
    disparity_compute.main(['--config', config])
    cfg = cfg_from_file(config)
    testing.write_synthetic_priors(cfg.path.preprocessed_path, cfg.obj_types, num_ratios=3)
    import visualdet3d_tpu_torch.data  # noqa: F401
    val = DATASET_DICT[cfg.data.val_dataset](cfg, 'validation')
    batch = val.collate_fn([val[0], val[1]])
    left, right = torch.from_numpy(batch['left_images']), torch.from_numpy(batch['right_images'])
    cfg.detector.inference_dtype = 'float32'  # the checkpoint is the f32 network's
    system = DETECTOR_DICT[cfg.detector.name](cfg.detector, device='cpu')
    testing.calibrate_prediction_convs(system, (left, right), torch.Generator().manual_seed(3))
    with torch.no_grad():
        cls = system.predict_raw(left, right)[0][..., :-1]
        system.prediction_convs()[0].bias += 1.5 - torch.quantile(cls.float(), 0.95)
    checkpoint.CheckpointManager(str(work / 'checkpoint')).save(
        0, {'model': system.net.state_dict()})
    return config, work


def test_quantized_artifact_evaluates_as_calibrating_on_the_fly(stereo_int8, capsys):
    config, work = stereo_int8
    ckpt, artifact = str(work / 'checkpoint'), str(work / 'int8.pt')
    quantize_cli.main(['--config', config, '--checkpoint_path', ckpt, '--output_path', artifact,
                       '--device', 'cpu'])
    assert 'saved the int8 artifact' in capsys.readouterr().out
    saved = checkpoint.load_params(artifact)
    assert saved.keys() == {'model', 'quant'} and len(saved['quant']) > 10
    np.random.seed(123)
    state = np.random.get_state()[1].copy()
    eval_cli.main(['--config', config, '--checkpoint_path', ckpt, '--device', 'cpu',
                   '--quantized_path', artifact])
    from_artifact = _result_files(work)
    eval_cli.main(['--config', config, '--checkpoint_path', ckpt, '--device', 'cpu'])
    np.testing.assert_array_equal(np.random.get_state()[1], state)  # calibration restored it
    on_the_fly = _result_files(work)
    assert from_artifact == on_the_fly
    assert sum(text.count(b'\n') for text in on_the_fly.values()) >= 1
    assert len(_check_table(capsys.readouterr().out, 2)) == 16  # two evals, two classes
    stats = _eval_stats(work)
    assert [s['quantized_path'] for s in stats] == [artifact, None]
    assert all(s['inference_dtype'] == 'int8' and len(s['frame_ms']) == 2 for s in stats)
