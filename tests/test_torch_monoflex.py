"""The ported MonoFlex slice against the JAX package, on the CPU.

Module by module (the depth decodes, the depth fusion, the IoU loss, the
target builder, the loss terms and their gradients with respect to the
head's maps), then the whole ``MonoFlex`` of ``configs/monoflex.py``
(DLA-34, ``head_features=256``) at 64x160, batch 2: the raw maps and
``predict`` in f32, the batched decode against the per-image one, and one
f32 training step through ``entry.build_monoflex_trainer(device='cpu')``'s
step function against ``jax.value_and_grad`` of the JAX system's loss and
an optax update (Adam, clipping at norm 35).

Weights: the trainer's system, seeded on the port's side and copied into a
flax tree of the JAX system's structure (``jax.eval_shape`` of its init),
which the bridge loads back strictly: for the predict, the offset convs
seeded to 1 px and the head's output convs calibrated; for the step, then
the running statistics set to the batch's, the offsets reseeded to 0.5 px
and the head calibrated again (``testing.prepare_km3d_for_training``). The JAX side runs jitted,
each JAX function once per module (fixtures); its f32 DCNs take the Pallas
kernel K5 where the pixel count allows (interpret mode) and the pairs path
elsewhere.

Tolerances (each with its reason at the assertion): exact for the target
builder; rtol 1e-6 for the elementwise decodes and the IoU loss; loss terms
rtol 1e-5 and their map gradients within 1e-5 of each gradient's max; the
raw maps rtol 1e-4 and atol 1e-4 of each map's std, then the same valid set
and labels, scores within 1e-5, boxes rtol = atol = 1e-3 and the depth rtol
1e-2 (the keypoint depths divide by keypoint height differences); the
training step as ``tests/test_torch_km3d_train.py`` holds KM3D's.
"""
import copy
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from visualdet3d_tpu.data.kitti.dataset.km3d_dataset import KittiMonoFlexDataset
from visualdet3d_tpu.data.kitti.kittidata import KittiObj as JaxKittiObj
from visualdet3d_tpu.models.heads import losses as jax_losses
from visualdet3d_tpu.models.heads import monoflex_head as jax_monoflex
from visualdet3d_tpu.models.heads import rtm3d_utils as jax_rtm
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
from visualdet3d_tpu.solver.optimizers import build_optimizer as jax_build_optimizer
import visualdet3d_tpu.models.detectors.km3d  # noqa: F401
from visualdet3d_tpu_torch import convert, entry, testing
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.data.kitti.dataset.km3d_dataset import MonoFlexTargetBuilder
from visualdet3d_tpu_torch.data.kitti.kittidata import KittiObj
from visualdet3d_tpu_torch.models.heads import losses, monoflex_head
from visualdet3d_tpu_torch.models.heads import rtm3d_utils as rtm

IMAGE_HW = (64, 160)
BATCH = 2
EPOCH = 10.0
MAX_DET = 16
BOX_TOL = dict(rtol=1e-3, atol=1e-3)
DEPTH = 6  # the depth column of the [.., 11] boxes


def _scaled_p2(image_hw):
    p2 = testing.KITTI_P2.copy()
    p2[0] *= image_hw[1] / testing.KITTI_P2_HW[1]
    p2[1] *= image_hw[0] / testing.KITTI_P2_HW[0]
    return p2


# --------------------------------------------------------------------------
# decodes and the IoU loss
# --------------------------------------------------------------------------

def test_decode_depth_from_keypoints_matches_jax():
    rng = np.random.default_rng(0)
    kps = rng.normal(0.0, 4.0, (3, 5, 10, 2)).astype(np.float32)
    kps[0, 0, 8, 1] = kps[0, 0, 9, 1] - 1.0  # a negative center height: relu, then clamp
    dims = rng.normal(1.6, 0.3, (3, 5, 3)).astype(np.float32)
    calib = np.broadcast_to(_scaled_p2(IMAGE_HW), (3, 5, 3, 4)).copy()
    ref = np.asarray(jax.jit(jax_rtm.decode_depth_from_keypoints)(kps, dims, calib))
    out = rtm.decode_depth_from_keypoints(*map(torch.from_numpy, (kps, dims, calib)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    assert ref.max() == 100.0 and (ref < 100.0).mean() > 0.3  # both sides of the clamp
    np.testing.assert_allclose(rtm.decode_depth_inv_sigmoid(torch.from_numpy(dims)).numpy(),
                               np.asarray(jax_rtm.decode_depth_inv_sigmoid(dims)), rtol=1e-6)


def test_decode_depth_from_keypoints_stops_the_height_gradient():
    kps = torch.randn(2, 10, 2, generator=torch.Generator().manual_seed(1)) * 4
    dims = torch.full((2, 3), 1.6, requires_grad=True)
    kps.requires_grad_()
    calib = torch.from_numpy(_scaled_p2(IMAGE_HW)).expand(2, 3, 4)
    rtm.decode_depth_from_keypoints(kps, dims, calib).sum().backward()
    assert dims.grad is None or float(dims.grad.abs().max()) == 0.0
    assert float(kps.grad.abs().max()) > 0


def test_merge_depth_matches_jax():
    rng = np.random.default_rng(2)
    depth = rng.uniform(5, 60, (2, 7, 4)).astype(np.float32)
    uncer = np.exp(rng.normal(0, 1, (2, 7, 4))).astype(np.float32)
    ref = np.asarray(jax.jit(jax_monoflex.merge_depth)(depth, uncer))
    out = monoflex_head.merge_depth(torch.from_numpy(depth), torch.from_numpy(uncer))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_iou_loss_matches_jax():
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.uniform(-3, 0, (50, 2)), rng.uniform(0, 3, (50, 2))], 1)
    b = a + rng.normal(0, 1, (50, 4))
    b[0] = a[0] + 10.0  # disjoint: the IoU clamps at eps
    a, b = a.astype(np.float32), b.astype(np.float32)
    ref = np.asarray(jax.jit(jax_losses.iou_loss)(a, b))
    out = losses.iou_loss(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    assert ref[0] == pytest.approx(-np.log(1e-8), rel=1e-6)


# --------------------------------------------------------------------------
# the target builder
# --------------------------------------------------------------------------

def _objects(cls, image_hw, P2):
    """Cars: inside the image, near and far, one partly outside (its right
    vertices leave the image), one wholly outside (no target), one beside
    another (overlapping heatmaps), one whose top corners leave the image
    (two of its keypoint depths are invalid)."""
    specs = [  # x, y, z, ry, (l, t, r, b) as fractions of the image
        (-2.0, 1.6, 12.0, 0.3, (0.30, 0.40, 0.55, 0.80)),
        (4.0, 1.7, 25.0, -1.2, (0.62, 0.42, 0.72, 0.60)),
        (6.0, 1.5, 11.0, 2.5, (0.85, 0.35, 1.10, 0.90)),   # partly outside
        (30.0, 1.6, 10.0, 0.0, (1.20, 0.40, 1.40, 0.70)),  # wholly outside
        (-1.0, 1.6, 13.0, -2.8, (0.40, 0.45, 0.62, 0.78)),
        (1.0, 0.3, 8.0, 0.6, (0.45, 0.00, 0.65, 0.60)),    # its top leaves the image
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


def _targets(objs_of, image_hw=IMAGE_HW, max_objects=8):
    P2 = _scaled_p2(image_hw)
    return MonoFlexTargetBuilder(['Car'], max_objects).build_target(image_hw, P2.copy(),
                                                                    objs_of(KittiObj))


def test_target_builder_matches_jax_exactly():
    image_hw = (96, 320)
    P2 = _scaled_p2(image_hw)
    ds = object.__new__(KittiMonoFlexDataset)
    ds.obj_types, ds.num_classes, ds.max_objects = ['Car'], 1, 8
    ref = ds._build_target(np.zeros((*image_hw, 3), np.float32), P2.copy(),
                           _objects(JaxKittiObj, image_hw, P2))
    out = _targets(lambda cls: _objects(cls, image_hw, P2), image_hw)
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].dtype == ref[key].dtype and out[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    # the cases are reached: five objects, one of them with invalid keypoint depths
    assert out['reg_mask'].tolist() == [1, 1, 1, 0, 1, 1, 0, 0]
    assert out['kp_detph_mask'][out['reg_mask'] == 1].min() == 0
    assert (out['bboxes2d_target'][out['reg_mask'] == 1] != 0).all()
    collated = MonoFlexTargetBuilder.collate_fn(
        [{'image': np.zeros((*image_hw, 3)), 'calib': P2, 'label': out}] * 2)
    assert all(v.shape == (2, *out[k].shape) for k, v in collated['gts'].items())


def test_synthetic_monoflex_batch_is_seeded_and_inside_the_image():
    a = testing.monoflex_training_batch(np.random.default_rng(5), 3, IMAGE_HW)
    b = testing.monoflex_training_batch(np.random.default_rng(5), 3, IMAGE_HW)
    for key in a['gts']:
        np.testing.assert_array_equal(a['gts'][key], b['gts'][key])
    n = a['gts']['reg_mask'].sum(axis=1)
    assert (n >= 2).all() and (n <= 6).all()
    keep = a['gts']['reg_mask'].astype(bool)
    assert (a['gts']['kp_detph_mask'][keep] == 1).all()  # every keypoint inside


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------

LOSS_MAP_STATS = {'hm': (-3.0, 1.5), 'bbox2d': (4.0, 1.5), 'hps': (0.0, 4.0),
                  'rot': (0.0, 1.0), 'dim': (1.6, 0.5), 'depth': (-3.0, 0.5),
                  'depth_uncertainty': (0.0, 1.0), 'corner_uncertainty': (0.0, 1.0),
                  'reg': (0.5, 0.2)}


@pytest.fixture(scope='module')
def loss_case():
    """Targets of two images (all six objects; the first two), maps of the
    head's statistics; the JAX loss and its map gradients, the port's."""
    P2 = _scaled_p2(IMAGE_HW)
    items = [{'image': np.zeros((*IMAGE_HW, 3), np.float32), 'calib': P2,
              'label': _targets(lambda cls, n=n: _objects(cls, IMAGE_HW, P2)[:n])}
             for n in (6, 2)]
    batch = MonoFlexTargetBuilder.collate_fn(items)
    rng = np.random.default_rng(9)
    h, w = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4
    maps = {name: rng.normal(mean, std, (BATCH, h, w, ch)).astype(np.float32)
            for name, ch in monoflex_head.MONOFLEX_HEAD_DICT.items()
            for mean, std in [LOSS_MAP_STATS[name]]}
    maps['hm'] = maps['hm'][..., :1]

    def jax_loss(m):
        return jax_monoflex.monoflex_loss(m, batch['gts'], batch['P2'], EPOCH)
    (ref_total, ref_terms), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in maps.items()})
    tmaps = {k: torch.from_numpy(v).requires_grad_() for k, v in maps.items()}
    gts = {k: torch.from_numpy(v) for k, v in batch['gts'].items()}
    total, terms = monoflex_head.monoflex_loss(tmaps, gts, torch.from_numpy(batch['P2']), EPOCH)
    total.backward()
    return batch, (ref_total, ref_terms, ref_grads), (total, terms,
                                                      {k: v.grad for k, v in tmaps.items()})


def test_monoflex_loss_terms_match_jax(loss_case):
    batch, (ref_total, ref_terms, _), (total, terms, _) = loss_case
    # a positive object whose keypoint depths are partly invalid: the
    # stop-gradient branch of the keypoint-depth loss is reached
    kp = batch['gts']['kp_detph_mask'][batch['gts']['reg_mask'] == 1]
    assert kp.min() == 0 and kp.max() == 1
    assert sorted(terms) == sorted(ref_terms)
    for name in ref_terms:
        np.testing.assert_allclose(float(terms[name].detach()), float(ref_terms[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        assert float(ref_terms[name]) != 0, name
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5)


def test_monoflex_loss_grads_match_jax(loss_case):
    _, (_, _, ref_grads), (_, _, grads) = loss_case
    for name, ref in ref_grads.items():
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


# --------------------------------------------------------------------------
# the whole MonoFlex: bridge, predict, decode, one training step
# --------------------------------------------------------------------------

_LEAF = {('params', 'kernel'): 'weight', ('params', 'bias'): 'bias',
         ('params', 'scale'): 'weight', ('batch_stats', 'mean'): 'running_mean',
         ('batch_stats', 'var'): 'running_var'}


def flax_variables_from_port(shapes, tsys):
    """The port's weights as a flax tree of the structure ``shapes`` (the
    JAX system's init under ``jax.eval_shape``; kernels OIHW -> HWIO): the
    weight bridge's inverse, so that a test needs no JAX init."""
    state = {k: v.detach().numpy() for k, v in tsys.net.state_dict().items()}

    def build(node, collection, path):
        out = {}
        for key, value in node.items():
            if hasattr(value, 'items'):
                out[key] = build(value, collection, path + (key,))
                continue
            arr = state['.'.join(path + (_LEAF[(collection, key)],))]
            if key == 'kernel':
                arr = arr.transpose(2, 3, 1, 0)
            assert arr.shape == value.shape, (path, key)
            out[key] = np.ascontiguousarray(arr)
        return out
    return {c: build(shapes[c], c, ()) for c in ('params', 'batch_stats')}


def _flipped(batch):
    """The batch in reverse order: identical math, other reduction orders."""
    return {'images': batch['images'][::-1].copy(), 'P2': batch['P2'][::-1].copy(),
            'gts': {k: v[::-1].copy() for k, v in batch['gts'].items()}}


@pytest.fixture(scope='module')
def pair():
    """The JAX and the port's MonoFlex with the same weights: the predict of
    both in f32, with the offset convs seeded to 1 px and the head
    calibrated (as ``tests/test_torch_km3d.py``); then, after the running
    statistics are set to the batch's, the offsets reseeded to 0.5 px (as
    ``tests/test_torch_km3d_train.py``) and the head calibrated again (at
    its initialisation the loss divides by keypoint heights near 0 and
    weighs by exp(-uncertainty) of any size), the trainer's step against
    the JAX gradient and optax update."""
    cfg = testing.monoflex_detector_cfg()
    jsys = JAX_DETECTORS['MonoFlex'](EasyDict(copy.deepcopy(cfg)))
    tsys, state, step = entry.build_monoflex_trainer(device='cpu', batch_size=BATCH)
    batch = testing.monoflex_training_batch(np.random.default_rng(12), BATCH, IMAGE_HW)
    batch['P2'][1] *= np.float32(0.98)
    images, P2 = batch['images'], batch['P2']
    gen = torch.Generator().manual_seed(13)
    testing.seed_offset_convs(tsys, gen, 1.0, torch.from_numpy(images))
    testing.calibrate_head_convs(tsys, torch.from_numpy(images), gen)
    # on a 16x40 map the calibrated heatmap's spread is mostly its border:
    # shift it so that 3% of the map scores above the 0.1 threshold
    with torch.no_grad():
        hm = tsys.predict_raw(torch.from_numpy(images))['hm'].float().flatten()
        tsys.net.KM3DHeadNet_0.hm_out.bias += math.log(0.1 / 0.9) + 0.3 - torch.quantile(hm, 0.97)
    tsys.weights_changed()
    shapes = jax.eval_shape(lambda k: jsys.init(k, IMAGE_HW, batch_size=BATCH),
                            jax.random.PRNGKey(0))
    variables = flax_variables_from_port(shapes, tsys)
    skipped = tsys.load_flax_variables(variables)
    n_flax = sum(np.asarray(leaf).size for leaf in jax.tree.leaves(variables))
    # one program for the JAX raw maps and predict (one compile)
    j_raw, j_det = jax.jit(lambda v, im, p: (jsys.net.apply(v, im, train=False),
                                             jsys.predict(v, im, p, max_detections=MAX_DET)))(
        variables, images, P2)
    raw = (j_raw, tsys.predict_raw(torch.from_numpy(images)))
    det = (j_det, tsys.predict(torch.from_numpy(images), torch.from_numpy(P2),
                               max_detections=MAX_DET))

    testing.prepare_km3d_for_training(tsys, torch.from_numpy(images), gen, offset_std=0.5)
    variables = flax_variables_from_port(shapes, tsys)

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
    # the loss terms' noise floor: the images moved by up to two f32 ulps
    u = np.random.default_rng(14).uniform(-1, 1, images.shape).astype(np.float32)
    (_, (j_terms_moved, _)), _ = grad_fn(variables['params'],
                                        dict(batch, images=images * (1 + 2.0 ** -22 * u)))
    # the trainer's epoch: the chen split's training frames at this batch size
    train_cfg = testing.monoflex_train_cfg(math.ceil(entry.KITTI_TRAIN_FRAMES / BATCH))
    tx = jax_build_optimizer(train_cfg.optimizer, train_cfg.scheduler,
                             train_cfg.steps_per_epoch)
    j_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, variables['params'])

    lr = state.optimizer.schedule(0)
    metrics = step({'images': torch.from_numpy(images), 'P2': torch.from_numpy(P2),
                    'gts': {k: torch.from_numpy(v) for k, v in batch['gts'].items()}}, EPOCH)

    def bridged(tree, collection='params'):
        def to_np(t):
            return {k: to_np(v) for k, v in t.items()} if hasattr(t, 'items') else np.asarray(t)
        return convert.flax_to_state_dict({collection: to_np(tree)})[0]
    return dict(tsys=tsys, state=state, skipped=skipped, n_flax=n_flax, raw=raw, det=det,
                P2=P2, lr=lr, metrics={k: float(v) for k, v in metrics.items()},
                jax=dict(loss=float(j_loss), terms={k: float(v) for k, v in j_terms.items()},
                         terms_moved={k: float(v) for k, v in j_terms_moved.items()},
                         grads=bridged(j_grads), grads_flipped=bridged(j_grads_flipped),
                         params=bridged(j_params), stats=bridged(j_stats, 'batch_stats')))


def test_bridge_loads_the_monoflex_net_strictly(pair):
    assert pair['skipped'] == []
    tsys = pair['tsys']
    n_torch = sum(t.numel() for k, t in tsys.net.state_dict().items()
                  if not k.endswith('num_batches_tracked'))
    assert pair['n_flax'] == n_torch
    heads = dict(tsys.head_dict)
    assert heads == dict(monoflex_head.MONOFLEX_HEAD_DICT, hm=1)


def test_raw_outputs_match_jax_f32(pair):
    ref, out = pair['raw']
    assert sorted(out) == sorted(ref) == sorted(monoflex_head.MONOFLEX_HEAD_DICT)
    for name in ref:
        r = np.asarray(ref[name])
        assert out[name].shape == r.shape == (BATCH, 16, 40, dict(pair['tsys'].head_dict)[name])
        np.testing.assert_allclose(out[name].numpy(), r, rtol=1e-4, atol=1e-4 * r.std(),
                                   err_msg=name)


def test_predict_matches_jax_f32(pair):
    """The same valid set and labels; scores within 1e-5; the 2D box, the
    projected 3D center, the dimensions and alpha rtol = atol = 1e-3; the
    depth rtol 1e-2 (it fuses keypoint depths, each a division by a
    keypoint height difference)."""
    ref, out = pair['det']
    valid = np.asarray(ref['valid'])
    assert 2 * BATCH <= valid.sum() < valid.size  # the calibrated head gives NMS work to do
    np.testing.assert_array_equal(out['valid'].numpy(), valid)
    np.testing.assert_array_equal(out['labels'].numpy()[valid], np.asarray(ref['labels'])[valid])
    np.testing.assert_allclose(out['scores'].numpy(), np.asarray(ref['scores']), atol=1e-5)
    o, r = out['bboxes'].numpy()[valid], np.asarray(ref['bboxes'])[valid]
    other = [c for c in range(11) if c != DEPTH]
    np.testing.assert_allclose(o[:, other], r[:, other], **BOX_TOL)
    np.testing.assert_allclose(o[:, DEPTH], r[:, DEPTH], rtol=1e-2, atol=1e-3)
    assert np.isfinite(o).all() and (o[:, DEPTH] > 0).all()


def test_batched_decode_equals_per_image(pair):
    """The batched decode (the JAX package vmaps a per-image one) gives
    exactly the per-image results."""
    _, raw = pair['raw']
    raw = {k: v.float() for k, v in raw.items()}
    P2 = torch.from_numpy(pair['P2'])
    kw = dict(score_thr=0.1, nms_iou_thr=0.5, top_k=100, max_detections=MAX_DET)
    batched = monoflex_head.monoflex_decode(raw, P2, IMAGE_HW, **kw)
    assert batched['valid'].any()
    for i in range(BATCH):
        single = monoflex_head.monoflex_decode({k: v[i:i + 1] for k, v in raw.items()},
                                               P2[i:i + 1], IMAGE_HW, **kw)
        for key in single:
            assert torch.equal(single[key], batched[key][i:i + 1]), key


def test_train_step_loss_matches_jax(pair):
    """Every loss term within rtol 2e-4, the JAX package's own bound for a
    change of reduction order (``tests/test_km3d.py``), or, where more, 8x
    JAX's own change when the images move by up to two f32 ulps (as
    ``chip_smoke.py``'s ``km3d_train_parity``): MonoFlex's depth terms
    weigh exp(-depth) by exp(-uncertainty), which amplifies the raw maps'
    summation-order differences past 2e-4."""
    terms, ref, moved = pair['metrics'], pair['jax']['terms'], pair['jax']['terms_moved']
    for name, value in ref.items():
        tol = max(2e-4 * abs(value), 8 * abs(moved[name] - value)) + 1e-7
        assert abs(terms[name] - value) <= tol, (name, terms[name], value, moved[name])
    np.testing.assert_allclose(terms['total'], pair['jax']['loss'],
                               rtol=max(2e-4, 8 * abs(moved['total_loss'] / ref['total_loss'] - 1)))


def _clipped(grads, max_norm=35.0):
    """optax.clip_by_global_norm: the gradients scaled to a global norm of at
    most ``max_norm``; and whether they were."""
    norm = sum(float(g.double().norm()) ** 2 for g in grads.values()) ** 0.5
    scale = max_norm / max(norm, max_norm)
    return {k: g * scale for k, g in grads.items()}, norm > max_norm


def test_train_step_gradients_match_jax(pair):
    """Self-calibrated, as ``tests/test_torch_km3d_train.py`` holds KM3D's:
    the noise floor is the JAX gradient of the reversed batch; the port's
    largest elementwise difference at most 8x the floor's (and 5e-2 of the
    largest gradient), its norm-wise difference at most 3x the floor's. The
    port's ``.grad`` after the step is clipped to norm 35 in place, so both
    JAX gradients are clipped alike (the clip is active here)."""
    params = dict(pair['tsys'].net.named_parameters())
    ref, was_clipped = _clipped(pair['jax']['grads'])
    flipped, _ = _clipped(pair['jax']['grads_flipped'])
    assert was_clipped
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
    dcn = [n for n in params if n.endswith('ModulatedDeformConv_0.weight')]
    assert len(dcn) == 16 and all(float(grad(n).abs().max()) > 0 for n in dcn)


def test_train_step_batch_stats_and_params_match_jax(pair):
    """Batch statistics within 1e-4 of their largest value; parameters after
    the Adam step (gradients clipped at norm 35 on both sides) within
    2.5 * lr: a first Adam step moves each element by lr * g / (|g| + eps),
    so the sign of a near-zero gradient costs up to 2 * lr."""
    tsys, ref = pair['tsys'], pair['jax']
    buffers = dict(tsys.net.named_buffers())
    for name, value in ref['stats'].items():
        if name.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(), rtol=0,
                                   atol=1e-4 * float(value.abs().max()), err_msg=name)
    params = dict(tsys.net.named_parameters())
    worst = max(float((params[n].detach() - v).abs().max()) for n, v in ref['params'].items())
    assert pair['lr'] == pytest.approx(3e-4)
    assert worst <= 2.5 * pair['lr'], (worst, pair['lr'])
    assert pair['state'].step == 1 and pair['state'].optimizer.count == 1
