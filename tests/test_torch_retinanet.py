"""The ported RetinaNet 2D detector against the JAX package, on the CPU.

* ``FPN`` at an odd pyramid (9x13, 5x7, 3x4: the top-down upsampling is
  not an exact x2, so ``jax.image.resize``'s half-pixel 'nearest' shows,
  and the stride-2 extra levels pad as flax's 'SAME') within 1e-4 of the
  largest value;
* ``_encode_2d`` / ``_decode_2d`` at 1e-6;
* the whole detector at ``tests/test_retinanet_monodepth.py``'s size
  (ResNet-18 with the stem and stage 1 frozen and BatchNorm in eval mode,
  as ``configs/retinanet_2d.py``; 64x128, ``stacked_convs=1``,
  ``feat_channels=64``, batch 2), weights carried across by the bridge:
  the raw class and box maps f32 within 1e-4 of their largest value, the
  loss terms at rtol 1e-4, ``predict``'s valid set and labels equal and
  boxes at 1e-3, the bf16 maps within max(3e-2, 1.5x JAX's own
  bf16-to-f32 distance), one f32 step of ``entry.build_retinanet_trainer``'s
  trainer (SGD with momentum and weight decay, clipping) against
  ``jax.value_and_grad`` + optax, the frozen stages' parameters moved by
  the weight decay alone, as optax moves them;
* the 2-D branch of ``test_one`` writing the KITTI lines JAX writes.

The prediction convs are seeded (``testing.calibrate_prediction_convs``):
zero as initialised, every score would sit at the prior 0.01.
"""
import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from visualdet3d_tpu.config import EasyDict as JaxEasyDict
from visualdet3d_tpu.models.detectors import retinanet as jax_retinanet
from visualdet3d_tpu.models.detectors.yolo3d import cast_floating
from visualdet3d_tpu.pipelines import evaluators as jax_evaluators
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
from visualdet3d_tpu.registry import PIPELINE_DICT as JAX_PIPELINES
from visualdet3d_tpu.solver.optimizers import build_optimizer as jax_build_optimizer
import visualdet3d_tpu.pipelines  # noqa: F401
from visualdet3d_tpu_torch import convert, entry, testing
from visualdet3d_tpu_torch.models.detectors import retinanet
from visualdet3d_tpu_torch.pipelines import evaluators, testers  # noqa: F401
from visualdet3d_tpu_torch.registry import DETECTOR_DICT, PIPELINE_DICT
import visualdet3d_tpu_torch.models  # noqa: F401

from test_torch_gac import _to_dict, flax_from_port

IMAGE_HW = (64, 128)
BATCH = 2
MAX_DET = 16
BOX_TOL = dict(rtol=1e-3, atol=1e-3)


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


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _close(out, ref, rel, what=''):
    """max|out - ref| <= rel * max|ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0, what
    assert np.abs(out - ref).max() <= rel * scale, (what, np.abs(out - ref).max(), scale)


def test_fpn_matches_jax_at_an_odd_pyramid():
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((2, h, w, c)).astype(np.float32)
             for h, w, c in ((9, 13, 8), (5, 7, 16), (3, 4, 32))]
    jfpn = jax_retinanet.FPN(16, 5)
    variables = jax.jit(jfpn.init)(jax.random.PRNGKey(1), feats)
    variables = {'params': jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.1, x.shape).astype(np.float32),
        _to_dict(variables['params']))}  # non-zero biases
    ref = jax.jit(jfpn.apply)(variables, feats)
    fpn = retinanet.FPN([8, 16, 32], 16, 5)
    convert.load_flax_variables(fpn, variables)
    with torch.no_grad():
        out = fpn([_nchw(f) for f in feats])
    assert [tuple(o.shape[2:]) for o in out] == [(9, 13), (5, 7), (3, 4), (2, 2), (1, 1)]
    for i, (o, r) in enumerate(zip(out, ref)):
        assert tuple(r.shape[1:3]) == tuple(o.shape[2:]), i
        _close(o.permute(0, 2, 3, 1).numpy(), r, 1e-4, f'level {i}')


def test_encode_decode_match_jax():
    """Random anchors and boxes (degenerate widths clipped at 1e-6 in the
    encode), means and stds off their defaults: both ways at 1e-6, and the
    round trip."""
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 100, (50, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 60, (50, 2))], 1).astype(np.float32)
    gxy = rng.uniform(0, 100, (3, 50, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(0, 60, (3, 50, 2))], -1).astype(np.float32)
    gt[0, :5, 2] = gt[0, :5, 0]  # zero width
    means = np.array([0.1, -0.1, 0.0, 0.05], np.float32)
    stds = np.array([0.5, 0.5, 1.0, 1.0], np.float32)
    deltas = retinanet._encode_2d(_t(anchors), _t(gt), _t(means), _t(stds))
    for b in range(3):
        ref = np.asarray(jax_retinanet._encode_2d(anchors, gt[b], means, stds))
        np.testing.assert_allclose(deltas[b].numpy(), ref, rtol=1e-6, atol=1e-6)
        dref = np.asarray(jax_retinanet._decode_2d(anchors, ref, means, stds))
        np.testing.assert_allclose(retinanet._decode_2d(_t(anchors), _t(ref), _t(means),
                                                        _t(stds)).numpy(), dref, rtol=1e-6,
                                   atol=1e-6 * np.abs(dref).max())
        np.testing.assert_allclose(dref[5:], gt[b, 5:], rtol=1e-4, atol=1e-3)


def _cfg():
    cfg = testing.retinanet_detector_cfg(depth=18)
    cfg.neck.in_channels = [128, 256, 512]
    cfg.neck.out_channels = 64
    cfg.head.update(stacked_convs=1, in_channels=64, feat_channels=64)
    return cfg


def _annotations(rng):
    """Boxes of the three classes at anchor scales (the JAX test's and a
    few more), class -1 padding."""
    ann = np.full((BATCH, 6, 12), -1.0, np.float32)
    ann[0, 0, :5] = [10, 10, 44, 42, 0]
    ann[0, 1, :5] = [60, 20, 120, 52, 1]
    ann[0, 2, :5] = [4, 30, 20, 62, 2]
    ann[1, 0, :5] = [30, 30, 62, 62, 2]
    ann[1, 1, :5] = [70, 2, 126, 60, 0]
    return ann


@pytest.fixture(scope='module')
def pair():
    cfg = _cfg()
    jsys = JAX_DETECTORS['RetinaNet'](JaxEasyDict(copy.deepcopy(dict(cfg))))
    tsys = DETECTOR_DICT['RetinaNet'](copy.deepcopy(cfg), device='cpu')
    rng = np.random.default_rng(3)
    images = rng.standard_normal((BATCH, *IMAGE_HW, 3)).astype(np.float32)
    testing.calibrate_prediction_convs(tsys, (_t(images),), torch.Generator().manual_seed(4))
    with torch.no_grad():  # the class bias moved (by at most 0.05) to keep every logit off 0
        logits = tsys.predict_raw(_t(images))[0].double().ravel()
        shifts = torch.linspace(-0.05, 0.05, 101, dtype=torch.float64)
        margin = (logits[None] + shifts[:, None]).abs().min(dim=1).values
        tsys.net.retina_cls.bias += float(shifts[margin.argmax()])
    tsys.weights_changed()
    shapes = jax.eval_shape(lambda k: jsys.init(k, IMAGE_HW, batch_size=BATCH),
                            jax.random.PRNGKey(0))
    variables = flax_from_port(shapes, tsys.net)
    assert tsys.load_flax_variables(variables) == []
    P2 = np.tile(testing._kitti_P2(IMAGE_HW[1]), (BATCH, 1, 1))

    j_raw, j_det = jax.jit(lambda v, im: (jsys.net.apply(v, im, train=False),
                                          jsys.predict(v, im, max_detections=MAX_DET)))(
        variables, images)
    raw = (j_raw, tsys.predict_raw(_t(images)))
    det = (j_det, tsys.predict(_t(images), _t(P2), max_detections=MAX_DET))
    v16 = cast_floating(variables, jnp.bfloat16)
    j16 = jax.jit(lambda v, im: jsys.net.apply(v, im, train=False))(
        v16, images.astype(jnp.bfloat16))
    tsys.cfg.inference_dtype = 'bfloat16'
    t16 = tsys.predict_raw(_t(images))
    tsys.cfg.inference_dtype = 'float32'

    files = _write_test_one(cfg, jsys, tsys, variables, images, P2)

    ann = _annotations(rng)
    batch = dict(images=images, P2=P2.astype(np.float32), annotations=ann)

    def loss_fn(params, b):
        (cls_loss, reg_loss, terms), _ = jsys.loss(
            {'params': params, 'batch_stats': variables['batch_stats']}, b['images'], b['P2'],
            b['annotations'], train=True)
        return cls_loss.mean() + reg_loss.mean(), terms
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (j_loss, j_terms), j_grads = grad_fn(variables['params'], batch)
    _, j_grads_flipped = grad_fn(variables['params'],
                                 {k: v[::-1].copy() for k, v in batch.items()})
    train_cfg = testing.retinanet_train_cfg(math.ceil(entry.KITTI_TRAIN_FRAMES / BATCH))
    tx = jax_build_optimizer(train_cfg.optimizer, train_cfg.scheduler, train_cfg.steps_per_epoch)
    j_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, variables['params'])

    init = {n: p.detach().clone() for n, p in tsys.net.named_parameters()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(entry, 'build_retinanet_system', lambda device=None: tsys)
        _, state, step = entry.build_retinanet_trainer(device='cpu', batch_size=BATCH)
    grads, update = {}, state.optimizer.step

    def recording_update():  # the gradients before the update clips them in place
        grads.update({n: p.grad.clone() for n, p in tsys.net.named_parameters()})
        update()
    state.optimizer.step = recording_update
    metrics = {k: float(v) for k, v in step({k: _t(v) for k, v in batch.items()}).items()}

    def bridged(tree):
        return convert.flax_to_state_dict({'params': _to_dict(tree)})[0]
    return dict(
        tsys=tsys, files=files, raw=raw, det=det, j16=(j_raw, j16), t16=t16, init=init, state=state, grads=grads,
        metrics=metrics, jax=dict(loss=float(j_loss), terms={k: float(v[0]) for k, v in
                                                             j_terms.items()},
                                  grads=bridged(j_grads), grads_flipped=bridged(j_grads_flipped),
                                  params=bridged(j_params)))


def test_raw_maps_match_jax(pair):
    """The class logits and box deltas [B, N, C] (N = 1539 anchors of five
    levels at 64x128) within 1e-4 of their largest value."""
    (j_cls, j_reg), (t_cls, t_reg) = pair['raw']
    n = pair['tsys'].anchor_pack(IMAGE_HW).shape[0]
    assert t_cls.shape == j_cls.shape == (BATCH, n, 3) and t_reg.shape == (BATCH, n, 4)
    _close(t_cls.numpy(), j_cls, 1e-4, 'cls')
    _close(t_reg.numpy(), j_reg, 1e-4, 'reg')


def test_predict_matches_jax(pair):
    """The same valid set and labels, scores within 1e-5, boxes at rtol =
    atol = 1e-3; every class logit at least 1e-3 from the score threshold's
    logit (0), so that the valid set is a property of the function."""
    (j_cls, _), _ = pair['raw']
    assert float(np.abs(np.asarray(j_cls)).min()) > 1e-3
    ref, out = pair['det']
    valid = np.asarray(ref['valid'])
    assert valid.sum(axis=1).min() >= 2, valid.sum(axis=1)
    np.testing.assert_array_equal(out['valid'].numpy(), valid)
    np.testing.assert_array_equal(out['labels'].numpy()[valid], np.asarray(ref['labels'])[valid])
    np.testing.assert_allclose(out['scores'].numpy(), np.asarray(ref['scores']), atol=1e-5)
    np.testing.assert_allclose(out['bboxes'].numpy()[valid], np.asarray(ref['bboxes'])[valid],
                               **BOX_TOL)


def test_bf16_maps_match_jax(pair):
    """Each bf16 map (the whole network on a bf16 copy) within max(3e-2,
    1.5x JAX's own bf16-to-f32 distance) of JAX's bf16 map, norm-wise."""
    (j32_cls, j32_reg), (j16_cls, j16_reg) = pair['j16']
    t_cls, t_reg = pair['t16']
    assert t_cls.dtype == t_reg.dtype == torch.bfloat16 and j16_cls.dtype == jnp.bfloat16
    for out, ref16, ref32 in ((t_cls, j16_cls, j32_cls), (t_reg, j16_reg, j32_reg)):
        ref16 = np.asarray(ref16, np.float32)
        ref32 = np.asarray(ref32, np.float32)
        own = np.linalg.norm(ref16 - ref32) / np.linalg.norm(ref32)
        err = np.linalg.norm(out.float().numpy() - ref16) / np.linalg.norm(ref16)
        assert err <= max(3e-2, 1.5 * own), (err, own)


def test_loss_terms_match_jax(pair):
    """The focal and IoU terms, each normalised by the positives, within
    rtol 1e-4; positives were assigned (the IoU term is positive)."""
    terms, ref = pair['metrics'], pair['jax']['terms']
    assert sorted(ref) == ['cls_loss', 'reg_loss', 'total_loss']
    for name, value in ref.items():
        assert value > 0, name
        np.testing.assert_allclose(terms[name], value, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(terms['total'], pair['jax']['loss'], rtol=1e-4)


def _flat(grads):
    return torch.cat([grads[n].double().ravel() for n in sorted(grads)])


def test_train_step_gradients_match_jax(pair):
    """Self-calibrated, as ``tests/test_torch_gac.py``: the floor is the
    JAX gradient of the reversed batch. The largest elementwise difference
    at most 8x the floor's (and 5e-2 of the largest gradient), the
    norm-wise difference at most 3x the floor's; the frozen stem and stage
    1 get exactly 0, the towers, the FPN and stage 2 get gradients."""
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
    for name, g in grads.items():
        frozen = name.startswith(('ResNet_0.conv1', 'ResNet_0.BatchNorm_0', 'ResNet_0.layer1_'))
        assert (float(g.abs().max()) == 0) == frozen, name
        assert (float(ref[name].abs().max()) == 0) == frozen, name


def test_train_step_params_match_jax(pair):
    """After the SGD step (momentum 0.9, weight decay 1e-4, clipping at
    35) every parameter within 1e-6 + lr x 8x the gradient floor of JAX's,
    the frozen ones moved by ``lr * 1e-4 * p`` exactly as optax moves them;
    one update, the network back in eval mode."""
    tsys, ref, init = pair['tsys'], pair['jax'], pair['init']
    lr = pair['state'].optimizer.schedule(0)
    assert lr == pytest.approx(0.01)
    floor = max(float((pair['jax']['grads_flipped'][n] - g).abs().max())
                for n, g in ref['grads'].items())
    params = dict(tsys.net.named_parameters())
    for name, value in ref['params'].items():
        np.testing.assert_allclose(params[name].detach().numpy(), value.numpy(), rtol=0,
                                   atol=1e-6 + lr * 8 * floor, err_msg=name)
    stem = params['ResNet_0.conv1.weight'].detach()
    assert not torch.equal(stem, init['ResNet_0.conv1.weight'])
    np.testing.assert_allclose(stem.numpy(), (init['ResNet_0.conv1.weight'] * (1 - lr * 1e-4))
                               .numpy(), rtol=1e-6, atol=1e-9)
    assert pair['state'].step == 1 and pair['state'].optimizer.count == 1
    assert not tsys.net.training


class _Frames:
    """Two 2-D frames at the network's size, as the mono dataset gives
    them: images, the calibration and the original shape (a crop of 16
    rows on top of a 80x128 frame)."""

    def __init__(self, images, P2):
        self.images, self.P2 = images, P2

    def __getitem__(self, i):
        return dict(image=self.images[i], calib=self.P2[i], original_shape=(80, 128, 3))

    @staticmethod
    def collate_fn(items):
        return dict(images=np.stack([d['image'] for d in items]),
                    P2=np.stack([d['calib'] for d in items]))


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


def _write_test_one(cfg, jsys, tsys, variables, images, P2):
    """Each frame through ``test_mono_detection`` and ``test_one`` on both
    sides: {file name: (the port's rows, JAX's rows)}."""
    import tempfile
    cfg = copy.deepcopy(cfg)
    cfg.data = JaxEasyDict(augmentation=JaxEasyDict(crop_top_height=64))
    frames = _Frames(images, P2.astype(np.float32))
    jfn = JAX_PIPELINES['test_mono_detection'](jsys, max_detections=MAX_DET)
    tfn = PIPELINE_DICT['test_mono_detection'](tsys, max_detections=MAX_DET)
    with tempfile.TemporaryDirectory() as out:
        for side in ('jax', 'port'):
            os.makedirs(os.path.join(out, side))
        for i in range(BATCH):
            jax_evaluators.test_one(cfg, i, frames, variables, jfn, os.path.join(out, 'jax'))
            evaluators.test_one(cfg, i, frames, tfn, os.path.join(out, 'port'))
        return {name: (_rows(os.path.join(out, 'port', name)),
                       _rows(os.path.join(out, 'jax', name)))
                for name in sorted(os.listdir(os.path.join(out, 'jax')))}


def test_test_one_writes_the_kitti_lines_jax_writes(pair):
    """``test_mono_detection`` then ``test_one``'s 2-D branch (the boxes
    moved back by the crop of ``crop_top_height``): the same lines, class
    names equal and numbers within 1e-3."""
    n_lines = 0
    assert len(pair['files']) == BATCH
    for name, (out, ref) in pair['files'].items():
        assert len(out) == len(ref), name
        n_lines += len(ref)
        for a, b in zip(out, ref):
            assert a[0] == b[0] and len(a) == len(b) == 16
            np.testing.assert_allclose([float(v) for v in a[1:]], [float(v) for v in b[1:]],
                                       rtol=1e-3, atol=1e-3)
    assert n_lines >= 2


def test_bn_fold_keeps_the_predictions():
    """``fold_inference_variables`` (the bf16 evaluation's first step)
    folds the trunk's BatchNorms into its bias-free convs (each BN keeps a
    pure shift) and leaves the raw maps within 1e-5 of their largest
    value."""
    tsys = DETECTOR_DICT['RetinaNet'](_cfg(), device='cpu')
    images = _t(np.random.default_rng(7).standard_normal((1, *IMAGE_HW, 3)).astype(np.float32))
    testing.prepare_retinanet(tsys, images, torch.Generator().manual_seed(8))
    before = tsys.predict_raw(images)
    pairs = tsys.fold_inference_variables(IMAGE_HW)
    assert len(pairs) == 20  # the stem, 16 in the blocks, 3 projections
    for out, ref in zip(tsys.predict_raw(images), before):
        _close(out.numpy(), ref.numpy(), 1e-5)


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    """Without CUDA the default device raises; the configs are
    ``configs/retinanet_2d.py``'s (92,070 anchors at 384x1280); int8 is
    refused until its slice; the NMS is class-aware under the misspelt
    key the JAX package reads."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for fn in (entry.build_retinanet_system, entry.build_retinanet_trainer):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            fn()
    cfg = testing.retinanet_detector_cfg()
    assert cfg.backbone.depth == 50 and cfg.backbone.frozen_stages == 1
    tsys = DETECTOR_DICT['RetinaNet'](_cfg(), device='cpu')
    assert tsys.anchors.anchors_for_shape(entry.RETINANET_IMAGE_HW).shape == (92070, 4)
    train = testing.retinanet_train_cfg()
    assert train.optimizer.type_name == 'sgd' and train.optimizer.clipped_gradient_norm == 35.0
    images = np.random.default_rng(5).standard_normal((1, *IMAGE_HW, 3)).astype(np.float32)
    testing.calibrate_prediction_convs(tsys, (_t(images),), torch.Generator().manual_seed(6))
    tsys.test_cfg.cls_agnositc = False
    aware = tsys.predict(_t(images), max_detections=MAX_DET)
    assert int(aware['valid'].sum()) > 0
    tsys.cfg.inference_dtype = 'int8'
    with pytest.raises(NotImplementedError, match='A5 item 5'):
        tsys.predict(_t(images))
