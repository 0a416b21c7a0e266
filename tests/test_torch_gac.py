"""The ported GAC mono slice (``GroundAwareYolo3D`` and the DCN-headed
``Yolo3D``) against the JAX package, on the CPU.

Module by module: ``grid_sample`` and ``grid_sample_2d`` in both padding
modes and both ``align_corners`` (values and the gradients with respect to
the image and the grid, at coordinates past every edge); ``linspace`` as
JAX rounds it; ``ground_plane_disparity``; ``LookGround`` with a non-zero
``alpha`` and rows pushed below the bottom border (forward and gradients);
a Bottleneck trunk (depth 50, three stages, the s2d stem) in eval and train
mode; both heads in eval and train mode. Then both whole detectors at
``tests/helpers.py::tiny_mono_cfg`` size (ResNet-18, 64x160, 32-wide
towers, batch 2): the f32 predict, the bf16 predict, the dtype every conv,
BatchNorm, DCN and ``LookGround`` computes in under bf16 inference and
under the mixed-precision policy, the f32 loss, and one f32 step of
``entry.build_gac_trainer(device='cpu')``'s trainer (the tiny system in
place of the full one) against ``jax.value_and_grad`` + optax.

Weights: the port's, seeded (``testing.prepare_mono_for_predict``: the
head DCN's offsets at 1 px, ``alpha`` 0.5, the prediction convs
calibrated; for the step, then ``testing.prepare_mono_for_training``)
and copied into a flax tree of the JAX system's structure (``jax.eval_shape``
of its init), which the weight bridge loads back strictly. The class
tower's dropout is off on both sides (it cannot draw JAX's bits). The JAX
side runs jitted, each whole-network program once per detector (module
fixture); its DCNs take the Pallas kernels K5 (f32) and K3 (bf16) in
interpret mode, and the pairs path in f32 training.

Tolerances (each with its reason at the assertion): sampling 1e-5 of the
largest value (torch forms the four corner weights, JAX lerps along x then
y); ``linspace`` exact in bf16; modules 1e-4 (conv summation order); the
detectors' f32 raw outputs rtol 1e-4 and atol 1e-4 of each output's std,
then the same valid set and labels, boxes rtol = atol = 1e-3; the bf16 raw
outputs within max(3e-2, 1.5x JAX's own bf16-to-f32 distance), norm-wise;
the step as ``tests/test_torch_stereo_train.py`` holds the stereo step's.
"""
import copy
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as flax_nn

from visualdet3d_tpu.models import blocks as jax_blocks
from visualdet3d_tpu.models.backbones.resnet import ResNet as JaxResNet
from visualdet3d_tpu.models.detectors.yolo3d import cast_floating
from visualdet3d_tpu.models.heads import detection_3d_head as jax_head
from visualdet3d_tpu.ops import sampling as jax_sampling
from visualdet3d_tpu.pipelines.train_state import _mp_scope
from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
from visualdet3d_tpu.solver.optimizers import build_optimizer as jax_build_optimizer
import visualdet3d_tpu.models.detectors.yolo3d  # noqa: F401
from visualdet3d_tpu_torch import convert, entry, testing
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.models import blocks
from visualdet3d_tpu_torch.models.backbones.resnet import BasicBlock, resnet
from visualdet3d_tpu_torch.models.detectors.km3d import KM3DCore
from visualdet3d_tpu_torch.models.heads import detection_3d_head
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.ops import sampling
from visualdet3d_tpu_torch.pipelines import trainers  # noqa: F401
from visualdet3d_tpu_torch.pipelines.train_state import TrainState, mixed_precision_apply
from visualdet3d_tpu_torch.registry import DETECTOR_DICT, PIPELINE_DICT
from visualdet3d_tpu_torch.solver.optimizers import build_optimizer
import visualdet3d_tpu_torch.models  # noqa: F401

from helpers import random_annotations, tiny_mono_cfg, write_fake_priors

IMAGE_HW = (64, 160)
BATCH = 2
MAX_DET = 16
HEADS = ('GroundAwareYolo3D', 'Yolo3D')
BOX_TOL = dict(rtol=1e-3, atol=1e-3)


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


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def sample_P2(batch, cy=30.0):
    """The JAX mono tests' calibration at 64x160; its ``cy`` at stride 16
    puts the bottom rows' analytic shift past the bottom border."""
    P2 = np.array([[220.0, 0.0, 80.0, 10.0],
                   [0.0, 220.0, cy, 0.1],
                   [0.0, 0.0, 1.0, 0.002]], np.float32)
    return np.repeat(P2[None], batch, axis=0)


_LEAF = {('params', 'kernel'): 'weight', ('params', 'bias'): 'bias',
         ('params', 'scale'): 'weight', ('params', 'alpha'): 'alpha',
         ('batch_stats', 'mean'): 'running_mean', ('batch_stats', 'var'): 'running_var'}


def flax_from_port(shapes, module: torch.nn.Module):
    """The port module's weights as a flax tree of the structure ``shapes``
    (kernels OIHW -> HWIO): the weight bridge's inverse. Copies: JAX on
    the CPU may read a numpy array in place, later than the call returns,
    while the port updates its running statistics in place."""
    state = {k: v.detach().float().numpy().copy() for k, v in module.state_dict().items()}

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
    return {c: build(shapes[c], c, ()) for c in ('params', 'batch_stats') if c in shapes}


@torch.no_grad()
def _nontrivial(module: torch.nn.Module, gen: torch.Generator, bias_std=0.1):
    """Seeded BatchNorm statistics and affines and conv biases."""
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            n = m.num_features
            m.weight.copy_(0.5 + torch.rand(n, generator=gen))
            m.bias.copy_(0.1 * torch.randn(n, generator=gen))
            m.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
            m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
        elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
            m.bias.copy_(bias_std * torch.randn(m.bias.shape, generator=gen))


def _no_dropout(next_fn, args, kwargs, context):
    """The JAX side's switch: every flax Dropout returns its input."""
    if isinstance(context.module, flax_nn.Dropout) and context.method_name == '__call__':
        return args[0]
    return next_fn(*args, **kwargs)


def _close(out, ref, rel, what=''):
    """max|out - ref| <= rel * max|ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(out - ref).max()
    assert err <= rel * scale, (what, err, scale)


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def _grid(rng, shape, lim=1.6):
    """Normalised coordinates in [-lim, lim] (past every edge), with a few
    exactly on -1, 1 and 0."""
    g = rng.uniform(-lim, lim, shape).astype(np.float32)
    flat = g.reshape(-1)
    flat[:6] = [-1.0, 1.0, 0.0, 1.0, -1.0, 0.0]
    return g


@pytest.mark.parametrize('padding_mode', ['border', 'zeros'])
@pytest.mark.parametrize('align_corners', [True, False])
def test_grid_sample_matches_jax(padding_mode, align_corners):
    """Values and both gradients of sum(out * r) at 1e-5 of their largest
    value. Past an edge 'border' gives the edge's value and no grid
    gradient on both sides; 'zeros' drops each corner outside on its own.
    At a 'border' coordinate exactly on the first pixel (the clamp's lower
    kink) the two take different one-sided derivatives: JAX the inside
    one, torch 0. ``LookGround`` has such points only in x (its grid's
    first column), whose gradient nothing reads; they are compared apart."""
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    grid = _grid(rng, (2, 4, 6, 2))
    r = rng.standard_normal((2, 4, 6, 3)).astype(np.float32)

    def jax_fn(im, g):
        return (jax_sampling.grid_sample(im, g, padding_mode, align_corners) * r).sum()
    ref = jax_sampling.grid_sample(jnp.asarray(images), jnp.asarray(grid), padding_mode,
                                   align_corners)
    ref_gi, ref_gg = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(images), jnp.asarray(grid))
    im, g = _t(images).requires_grad_(), _t(grid).requires_grad_()
    out = sampling.grid_sample(im, g, padding_mode, align_corners)
    (out * _t(r)).sum().backward()
    _close(out.detach().numpy(), ref, 1e-5, 'values')
    _close(im.grad.numpy(), ref_gi, 1e-5, 'image gradient')
    ref_gg, out_gg = np.asarray(ref_gg), g.grad.numpy()
    kink = np.zeros(grid.shape, bool)
    if padding_mode == 'border':
        size = np.array([7, 5], np.float32)
        pix = ((grid + 1) * 0.5 * (size - 1) if align_corners
               else ((grid + 1) * size - 1) * 0.5)
        kink = pix == 0
        assert (out_gg[kink] == 0).all() and (align_corners == kink.any())
    _close(np.where(kink, 0, out_gg), np.where(kink, 0, ref_gg), 1e-5, 'grid gradient')
    outside = (np.abs(grid) > 1).any(-1)
    assert outside.sum() > 10  # samples past the edges were compared
    if padding_mode == 'border':  # beyond the edge on an axis: no gradient along it
        past = np.abs(grid) > 1 + 1e-6
        assert (ref_gg[past] == 0).all() and (out_gg[past] == 0).all()


@pytest.mark.parametrize('padding_mode', ['border', 'zeros'])
def test_grid_sample_2d_matches_jax(padding_mode):
    """Pixel coordinates from 2.5 px before to 2.5 px after each edge, on a
    5x7 image and on a 1-pixel-wide one."""
    rng = np.random.default_rng(2)
    for hw in ((5, 7), (4, 1)):
        image = rng.standard_normal((*hw, 3)).astype(np.float32)
        coords = np.stack([rng.uniform(-2.5, hw[1] + 1.5, (3, 8)),
                           rng.uniform(-2.5, hw[0] + 1.5, (3, 8))], -1).astype(np.float32)
        ref = jax_sampling.grid_sample_2d(jnp.asarray(image), jnp.asarray(coords), padding_mode)
        out = sampling.grid_sample_2d(_t(image), _t(coords), padding_mode)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5, err_msg=str(hw))


@pytest.mark.parametrize('num', [2, 4, 10, 18, 40, 80, 160])
def test_linspace_rounds_as_jax(num):
    """bf16 exactly as ``jnp.linspace`` in a jitted program (each operation
    rounded); f32 within one ulp (XLA and torch divide differently)."""
    for jdt, tdt, ulp in ((jnp.bfloat16, torch.bfloat16, 0.0), (jnp.float32, torch.float32,
                                                                 2.0 ** -23)):
        ref = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, num, dtype=jdt))()
                         .astype(jnp.float32))
        out = blocks.linspace(-1.0, 1.0, num, tdt)
        assert out.dtype == tdt
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=ulp)
    assert not torch.equal(blocks.linspace(-1.0, 1.0, 80, torch.bfloat16),
                           torch.linspace(-1.0, 1.0, 80, dtype=torch.bfloat16))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_ground_plane_disparity_matches_jax(dtype):
    """Rows in the features' dtype, the rest in P2's (f32): the result is
    f32 either way."""
    P2 = sample_P2(2)
    P2[1, 1, 3] = -0.5  # Ty < 0
    ref = jax_blocks.ground_plane_disparity((2, 6, 5), jnp.asarray(P2), 0.54, 1.65, 16.0,
                                            dtype=jnp.dtype(dtype))
    out = blocks.ground_plane_disparity((2, 6, 5), _t(P2), 0.54, 1.65, 16.0,
                                        dtype=getattr(torch, dtype))
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    assert (np.asarray(ref) > 0).any() and (np.asarray(ref) == 0).any()


def _look_ground_pair(features=6, hw=(4, 10)):
    """Flax and port ``LookGround`` with the same seeded weights, alpha 0.7."""
    gen = torch.Generator().manual_seed(3)
    port = blocks.LookGround(features)
    blocks.flax_default_init_(port, gen)
    _nontrivial(port, gen)
    with torch.no_grad():
        port.alpha.fill_(0.7)
        port.Conv_0.weight.mul_(3.0)  # a disparity correction of a few hundredths
    jmod = jax_blocks.LookGround(features)
    x = np.zeros((2, *hw, features), np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, sample_P2(2))
    return jmod, port, flax_from_port(shapes, port)


def test_look_ground_matches_jax_forward_and_gradients():
    """A calibration with cy 10 px (0.6 rows at stride 16): the lower rows'
    grid lies below the bottom border, where the grid gradient is 0. The
    output within 1e-5 of its largest value; the gradients of sum(out * r)
    with respect to the features, the two convs and alpha within 1e-5 of
    each one's largest value. The disparity conv learns only through the
    grid, at 5%: its gradient is compared too."""
    jmod, port, variables = _look_ground_pair()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 10, 6)).astype(np.float32)
    P2 = sample_P2(2, cy=10.0)
    r = rng.standard_normal(x.shape).astype(np.float32)
    assert float(variables['params']['alpha'][0]) == pytest.approx(0.7)

    def jax_fn(params, xx):
        return (jmod.apply({'params': params}, xx, P2) * r).sum()
    ref = jmod.apply(variables, x, P2)
    g_params, g_x = jax.jit(jax.grad(jax_fn, argnums=(0, 1)))(variables['params'], x)
    xt = _nchw(x).requires_grad_()
    out = port(xt, _t(P2))
    (out * _nchw(r)).sum().backward()
    _close(_nhwc(out), ref, 1e-5, 'output')
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), g_x, 1e-5, 'd features')
    grads = convert.flax_to_state_dict({'params': _to_dict(g_params)})[0]
    for name, p in port.named_parameters():
        _close(p.grad.numpy(), grads[name].numpy(), 1e-5, name)
    assert float(port.Conv_0.weight.grad.abs().max()) > 0
    # rows below the border: the JAX grid's y > 1 there (the analytic shift)
    y_shift_rows = 1.535 * (np.arange(4) - 10.0 / 16) / (2 * (1.65 - 0.5 * 1.535)) / 2
    assert (np.linspace(-1, 1, 4) + np.maximum(y_shift_rows, 0) > 1.05).sum() >= 1


# --------------------------------------------------------------------------
# the Bottleneck trunk and the two heads
# --------------------------------------------------------------------------

@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_bottleneck_trunk_matches_jax(train):
    """ResNet-50's first three stages with the s2d stem at 32x64, batch 2,
    seeded BatchNorm statistics and affines: the three outputs within 1e-4
    of their largest value; in train mode (batch statistics) also the
    updated running statistics within 1e-4 of their largest value."""
    gen = torch.Generator().manual_seed(5)
    port = resnet(depth=50, num_stages=3, out_indices=(0, 1, 2), s2d_stem=True)
    blocks.flax_default_init_(port, gen)
    _nontrivial(port, gen)
    jmod = JaxResNet(depth=50, num_stages=3, out_indices=(0, 1, 2), dilations=(1, 1, 1),
                     s2d_stem=True)
    x = np.random.default_rng(6).standard_normal((2, 32, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    variables = flax_from_port(shapes, port)
    assert port.out_channels == [256, 512, 1024]
    if train:
        outs, state = jax.jit(lambda v, xx: jmod.apply(v, xx, train=True,
                                                       mutable=['batch_stats']))(variables, x)
        port.train()
    else:
        outs = jax.jit(lambda v, xx: jmod.apply(v, xx, train=False))(variables, x)
        port.eval()
    with torch.no_grad():
        t_outs = port(_nchw(x))
    for o, r in zip(t_outs, outs):
        _close(_nhwc(o), r, 1e-4, 'stage output')
    if train:
        stats = convert.flax_to_state_dict({'batch_stats': _to_dict(state['batch_stats'])})[0]
        buffers = dict(port.named_buffers())
        for name, value in stats.items():
            if not name.endswith('num_batches_tracked'):
                _close(buffers[name].numpy(), value.numpy(), 1e-4, name)


def _head_pair(name, train):
    gen = torch.Generator().manual_seed(7)
    kwargs = dict(num_anchors=8, num_cls_output=3, num_reg_output=12, cls_feature_size=16,
                  reg_feature_size=24)
    port = getattr(detection_3d_head, name)(32, **kwargs)
    blocks.flax_default_init_(port, gen)
    _nontrivial(port, gen)
    with torch.no_grad():
        for conv in port.prediction_convs():
            conv.weight.copy_(0.05 * torch.randn(conv.weight.shape, generator=gen))
        for m in port.modules():
            if isinstance(m, blocks.ModulatedDeformConv):  # offsets of about a pixel
                m.Conv_0.weight.copy_(0.3 * torch.randn(m.Conv_0.weight.shape, generator=gen))
            if isinstance(m, blocks.LookGround):
                m.alpha.fill_(0.5)
    jmod = getattr(jax_head, name)(**kwargs)
    x = np.random.default_rng(8).standard_normal((2, 4, 10, 32)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jmod.init(k, x, sample_P2(2), train=False),
                            jax.random.PRNGKey(0))
    return port.train(train), jmod, flax_from_port(shapes, port), x


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('name', ['GroundAwareHead', 'AnchorBasedDetection3DHead'])
def test_heads_match_jax(name, train):
    """Both heads on 32-channel features at 4x10, batch 2, the prediction
    convs, the DCN's offset conv and alpha seeded: the class and regression
    outputs within 1e-4 of their largest value, in eval mode and in train
    mode (batch statistics, dropout off), and the running statistics after
    the train-mode forward."""
    port, jmod, variables, x = _head_pair(name, train)
    P2 = sample_P2(2)

    def apply(v, xx):
        with flax_nn.intercept_methods(_no_dropout):
            return jmod.apply(v, xx, P2, train=train, mutable=['batch_stats'] if train else [])
    (cls, reg), state = jax.jit(apply)(variables, x)
    with torch.no_grad():
        t_cls, t_reg = port(_nchw(x), _t(P2))
    _close(t_cls.numpy(), cls, 1e-4, 'cls')
    _close(t_reg.numpy(), reg, 1e-4, 'reg')
    if train:
        stats = convert.flax_to_state_dict({'batch_stats': _to_dict(state['batch_stats'])})[0]
        buffers = dict(port.named_buffers())
        for key, value in stats.items():
            if not key.endswith('num_batches_tracked'):
                _close(buffers[key].numpy(), value.numpy(), 1e-4, key)


# --------------------------------------------------------------------------
# the whole detectors
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def priors(tmp_path_factory):
    pre = str(tmp_path_factory.mktemp('pre'))
    write_fake_priors(pre, ['Car'])
    return pre


def _cfg(priors, name):
    return EasyDict(copy.deepcopy(tiny_mono_cfg(priors, ground_aware=name == HEADS[0])))


# module types whose computing dtype the dtype tests compare (flax class
# name -> the port's classes)
DTYPE_MODULES = {'Conv': (torch.nn.Conv2d,), 'BatchNorm': (blocks.BatchNorm2d,),
                 'LookGround': (blocks.LookGround,),
                 'ModulatedDeformConv': (blocks.ModulatedDeformConv,)}


def _jax_dtypes(fn, *args):
    """{module path: output dtype name} of every Conv, BatchNorm, DCN and
    LookGround when ``fn(*args)`` is traced (``jax.eval_shape``: no
    compile). A conv's output dtype is the dtype it computes in (under the
    policy its input is cast before it)."""
    seen = {}

    def record(next_fn, a, kw, context):
        out = next_fn(*a, **kw)
        if context.method_name == '__call__' and type(context.module).__name__ in DTYPE_MODULES:
            seen['.'.join(context.module.path)] = jnp.dtype(out.dtype).name
        return out

    def traced(*xs):
        with flax_nn.intercept_methods(record):
            return fn(*xs)
    jax.eval_shape(traced, *args)
    return seen


def _port_dtypes(net, run):
    """The same map of the port's ``net`` while ``run()`` runs."""
    seen, handles = {}, []
    kinds = tuple(c for cs in DTYPE_MODULES.values() for c in cs)
    for name, m in net.named_modules():
        if isinstance(m, kinds):
            def hook(mod, args, out, name=name):
                seen[name] = str(out.dtype).replace('torch.', '')
            handles.append(m.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return seen


def _anchor_annotations(tsys, P2, rng, per_image=2):
    """``random_annotations`` rows whose 2-D boxes are useful anchors moved
    by up to 2 px a side (IoU above 0.5 without ``match_low_quality``, as
    the GAC config has it), so that every image has positives."""
    ann = random_annotations(rng, BATCH, image_hw=IMAGE_HW)
    pack = tsys.anchor_pack(IMAGE_HW)
    useful = tsys.anchors.useful_mask(pack, _t(P2)).numpy()
    anchors = pack['anchors'].numpy()
    for b in range(BATCH):
        for j, a in enumerate(rng.choice(np.flatnonzero(useful[b]), per_image, replace=False)):
            box = anchors[a] + rng.uniform(-2, 2, 4)
            ann[b, j, :4] = box
            ann[b, j, 4] = 0
            ann[b, j, 5:] = [(box[0] + box[2]) / 2, (box[1] + box[3]) / 2,
                             rng.uniform(5, 40), 1.6, 1.5, 3.9, rng.uniform(-np.pi, np.pi)]
    return ann


def _flipped(batch):
    """The batch in reverse order: identical math, other reduction orders."""
    return {k: v[::-1].copy() for k, v in batch.items()}


@pytest.fixture(scope='module', params=HEADS)
def pair(request, priors):
    name = request.param
    cfg = _cfg(priors, name)
    jsys = JAX_DETECTORS[name](copy.deepcopy(cfg))
    tsys = DETECTOR_DICT[name](copy.deepcopy(cfg), device='cpu')
    rng = np.random.default_rng(9)
    images = rng.standard_normal((BATCH, *IMAGE_HW, 3)).astype(np.float32)
    P2 = sample_P2(BATCH)
    gen = torch.Generator().manual_seed(10)
    testing.prepare_mono_for_predict(tsys, _t(images), _t(P2), gen, offset_std=1.0)
    # 64x160 has 80 useful anchors an image: shift the class logits so that
    # a tenth of them score above the 0.5 threshold (0.3 above it, not on it)
    with torch.no_grad():
        cls = tsys.predict_raw(_t(images), _t(P2))[0][..., 0]
        useful = tsys.anchors.useful_mask(tsys.anchor_pack(IMAGE_HW), _t(P2))
        tsys.prediction_convs()[0].bias += 0.3 - torch.quantile(cls[useful], 0.9)
    tsys.weights_changed()
    shapes = jax.eval_shape(lambda k: jsys.init(k, IMAGE_HW, batch_size=BATCH),
                            jax.random.PRNGKey(0))
    variables = flax_from_port(shapes, tsys.net)
    assert tsys.load_flax_variables(variables) == []

    # f32: the raw outputs and the predict, one program
    j_raw, j_det = jax.jit(lambda v, im, p: (jsys.net.apply(v, im, p, train=False),
                                             jsys.predict(v, im, p, max_detections=MAX_DET)))(
        variables, images, P2)
    dc.reset_launch_counts()
    raw = (j_raw, tsys.predict_raw(_t(images), _t(P2)))
    det = (j_det, tsys.predict(_t(images), _t(P2), max_detections=MAX_DET))
    # bf16 inference: the raw outputs, and the dtypes each module computes in
    v16 = cast_floating(variables, jnp.bfloat16)
    j16 = jax.jit(lambda v, im, p: jsys.net.apply(v, im, p, train=False))(
        v16, images.astype(jnp.bfloat16), P2)
    j16_dtypes = _jax_dtypes(lambda v, im, p: jsys.net.apply(v, im, p, train=False),
                             v16, images.astype(jnp.bfloat16), P2)
    tsys.cfg.inference_dtype = 'bfloat16'
    t16 = tsys.predict_raw(_t(images), _t(P2))
    t16_dtypes = _port_dtypes(tsys.inference_net(),
                              lambda: tsys.predict_raw(_t(images), _t(P2)))
    tsys.cfg.inference_dtype = 'float32'

    # training: one f32 step at these weights after the batch's statistics
    ann = _anchor_annotations(tsys, P2, np.random.default_rng(11))
    batch = dict(images=images, P2=P2, annotations=ann)
    testing.prepare_mono_for_training(tsys, _t(images), _t(P2), gen, offset_std=0.5)
    variables = flax_from_port(shapes, tsys.net)

    def jax_loss(policy):
        mp_ctx, mp_cast = _mp_scope('bfloat16' if policy else None)

        def loss_fn(params, b):
            with mp_ctx(), flax_nn.intercept_methods(_no_dropout):
                (cls_loss, reg_loss, terms), new_state = jsys.loss(
                    {'params': mp_cast(params), 'batch_stats': variables['batch_stats']},
                    b['images'], b['P2'], b['annotations'], rng=jax.random.PRNGKey(1),
                    train=True)
            return cls_loss.mean() + reg_loss.mean(), (terms, new_state['batch_stats'])
        return loss_fn
    policy_dtypes = (_jax_dtypes(jax_loss(True), variables['params'], batch),
                     _port_dtypes(tsys.net, lambda: tsys.loss(
                         _t(images), _t(P2), _t(ann), apply_fn=mixed_precision_apply('bfloat16'),
                         generator=torch.Generator().manual_seed(0))))
    tsys.net.load_state_dict(convert.flax_to_state_dict(variables)[0])  # undo the stats update

    grad_fn = jax.jit(jax.value_and_grad(jax_loss(False), has_aux=True))
    (j_loss, (j_terms, j_stats)), j_grads = grad_fn(variables['params'], batch)
    _, j_grads_flipped = grad_fn(variables['params'], _flipped(batch))
    train_cfg = testing.gac_train_cfg(math.ceil(entry.KITTI_TRAIN_FRAMES / BATCH))
    tx = jax_build_optimizer(train_cfg.optimizer, train_cfg.scheduler, train_cfg.steps_per_epoch)
    j_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, variables['params'])

    # the port's step: entry.build_gac_trainer's trainer on the tiny system
    tsys.dropout = False
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(entry, 'build_gac_system', lambda device=None, head=None: tsys)
        _, state, step = entry.build_gac_trainer(device='cpu', batch_size=BATCH)
    grads, update = {}, state.optimizer.step

    def recording_update():  # the gradients before the update clips them in place
        grads.update({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for n, p in tsys.net.named_parameters()})
        update()
    state.optimizer.step = recording_update
    metrics = {k: float(v) for k, v in step({k: _t(v) for k, v in batch.items()}).items()}

    def bridged(tree, collection='params'):
        return convert.flax_to_state_dict({collection: _to_dict(tree)})[0]
    return dict(
        name=name, tsys=tsys, raw=raw, det=det, j16=(j_raw, j16), t16=t16,
        launches=dict(dc.LAUNCHES), dtypes16=(j16_dtypes, t16_dtypes),
        policy_dtypes=policy_dtypes, state=state, grads=grads, metrics=metrics,
        lr=train_cfg.optimizer.keywords.lr,
        jax=dict(loss=float(j_loss), terms={k: float(v[0]) for k, v in j_terms.items()},
                 grads=bridged(j_grads), grads_flipped=bridged(j_grads_flipped),
                 params=bridged(j_params), stats=bridged(j_stats, 'batch_stats')))


def test_predict_f32_matches_jax(pair):
    """The raw outputs within rtol 1e-4 and atol 1e-4 of each one's std;
    then the same valid set and labels, scores within 1e-5, boxes rtol =
    atol = 1e-3. GAC's sampled branch is in it (alpha 0.5), and Yolo3D's
    DCN interpolates (offsets of 1 px)."""
    (j_cls, j_reg), (t_cls, t_reg) = pair['raw']
    for out, ref in ((t_cls, j_cls), (t_reg, j_reg)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * ref.std())
    ref, out = pair['det']
    valid = np.asarray(ref['valid'])
    assert valid.sum() >= 2, valid.sum()
    np.testing.assert_array_equal(out['valid'].numpy(), valid)
    np.testing.assert_array_equal(out['labels'].numpy()[valid], np.asarray(ref['labels'])[valid])
    np.testing.assert_allclose(out['scores'].numpy(), np.asarray(ref['scores']), atol=1e-5)
    np.testing.assert_allclose(out['bboxes'].numpy()[valid], np.asarray(ref['bboxes'])[valid],
                               **BOX_TOL)
    assert set(pair['launches'].values()) == {0}  # CPU: the plain versions


def test_predict_bf16_matches_jax(pair):
    """Each raw output of the port's bf16 predict within max(3e-2, 1.5x the
    JAX package's own bf16-to-f32 distance) of JAX's bf16 output,
    norm-wise (``||out - ref|| / ||ref||``): the two frameworks round at
    other places (a bf16 BatchNorm's factors, XLA's fused bf16 chains). The
    class logits stay bf16; GAC's regression output is f32 on both sides
    (its tower runs in f32 after ``LookGround``), Yolo3D's bf16."""
    (j32_cls, j32_reg), (j16_cls, j16_reg) = pair['j16']
    t_cls, t_reg = pair['t16']
    reg_dtype = jnp.float32 if pair['name'] == HEADS[0] else jnp.bfloat16
    assert j16_cls.dtype == jnp.bfloat16 and j16_reg.dtype == reg_dtype
    assert t_cls.dtype == torch.bfloat16 and str(t_reg.dtype) == f'torch.{jnp.dtype(reg_dtype)}'
    for out, ref16, ref32 in ((t_cls, j16_cls, j32_cls), (t_reg, j16_reg, j32_reg)):
        ref16 = np.asarray(ref16, np.float32)
        ref32 = np.asarray(ref32, np.float32)
        own = np.linalg.norm(ref16 - ref32) / np.linalg.norm(ref32)
        err = np.linalg.norm(out.float().numpy() - ref16) / np.linalg.norm(ref16)
        assert err <= max(3e-2, 1.5 * own), (err, own)


def test_bf16_inference_dtypes_match_jax(pair):
    """Every conv, BatchNorm, DCN and ``LookGround`` computes in JAX's dtype
    under bf16 inference: bf16 throughout, but for GAC ``LookGround``'s 1x1
    conv and the regression tower after it, f32 (P2 stays f32)."""
    ref, out = pair['dtypes16']
    assert out == ref
    look = [k for k in ref if k.endswith('LookGround_0')]
    if pair['name'] == HEADS[0]:
        assert ref[look[0]] == 'float32' and ref['GroundAwareHead_0.Conv_2'] == 'float32'
        assert ref['GroundAwareHead_0.LookGround_0.Conv_0'] == 'bfloat16'
    else:
        assert not look and set(ref.values()) == {'bfloat16'}


def test_policy_dtypes_match_jax(pair):
    """Under the mixed-precision policy every conv, BatchNorm, DCN and
    ``LookGround`` computes in bf16 on both sides: ``LookGround`` samples in
    f32 and its 1x1 conv casts the result to bf16, as JAX's interceptor
    casts every conv input."""
    ref, out = pair['policy_dtypes']
    assert out == ref and set(ref.values()) == {'bfloat16'}


def test_train_step_loss_matches_jax(pair):
    """Every loss term within rtol 2e-4 (the JAX package's bound for a
    change of reduction order); positives were assigned."""
    terms, ref = pair['metrics'], pair['jax']['terms']
    assert sorted(ref) == ['cls_loss', 'reg_loss', 'total_loss']
    for name, value in ref.items():
        assert value > 0, name
        np.testing.assert_allclose(terms[name], value, rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(terms['total'], pair['jax']['loss'], rtol=2e-4)


def _flat(grads, prefix=''):
    return torch.cat([grads[n].double().ravel() for n in sorted(grads) if n.startswith(prefix)])


def test_train_step_gradients_match_jax(pair):
    """Self-calibrated, as ``tests/test_torch_stereo_train.py``: the noise
    floor is the JAX gradient of the reversed batch. The largest
    elementwise difference at most 8x the floor's (and 5e-2 of the largest
    gradient), the norm-wise difference over all parameters at most 3x the
    floor's. The trunk, GAC's disparity conv (through the grid, 5% of its
    gradient) and alpha, and Yolo3D's DCN weight and offset conv get
    gradients."""
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
    head = pair['tsys'].net.head_name
    leaves = ['ResNet_0.layer1_0.Conv_0.weight']
    if pair['name'] == HEADS[0]:
        leaves += [f'{head}.LookGround_0.Conv_0.weight', f'{head}.LookGround_0.alpha']
    else:
        leaves += [f'{head}.ModulatedDeformConv_0.weight',
                   f'{head}.ModulatedDeformConv_0.Conv_0.weight']
    for name in leaves:
        assert float(grads[name].abs().max()) > 0, name
        rel = float((grads[name] - ref[name]).norm() / ref[name].norm())
        rel_floor = float((flipped[name] - ref[name]).norm() / ref[name].norm())
        assert rel <= max(4 * rel_floor, 1e-4), (name, rel, rel_floor)


def test_train_step_batch_stats_and_params_match_jax(pair):
    """The running statistics after the step within 1e-4 of their largest
    value; the parameters after the Adam step within 2.5 * lr (a first
    Adam step moves each element by lr * g / (|g| + eps)); one update."""
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


# --------------------------------------------------------------------------
# the step's skip rule, the entry points, the repaired message
# --------------------------------------------------------------------------

def test_skip_rule_at_zero_loss_keeps_params(priors):
    """No box: total 0, so the parameters and the Adam state stay while
    the step count advances and the running statistics move; dropout on,
    from the step's own generator."""
    tsys = DETECTOR_DICT['GroundAwareYolo3D'](_cfg(priors, 'GroundAwareYolo3D'), device='cpu')
    cfg = testing.gac_train_cfg(10)
    state = TrainState(build_optimizer(tsys.net.parameters(), cfg.optimizer, cfg.scheduler, 10))
    step = PIPELINE_DICT['train_mono_detection'](tsys)
    rng = np.random.default_rng(12)
    batch = dict(images=_t(rng.standard_normal((BATCH, *IMAGE_HW, 3)).astype(np.float32)),
                 P2=_t(sample_P2(BATCH)),
                 annotations=_t(random_annotations(rng, BATCH, image_hw=IMAGE_HW)))
    assert float(step(state, batch)['total']) > 0 and state.optimizer.count == 1
    params = {k: v.clone() for k, v in tsys.net.named_parameters()}
    buffers = {k: v.clone() for k, v in tsys.net.named_buffers()}
    empty = dict(batch, annotations=torch.full_like(batch['annotations'], -1.0))
    assert float(step(state, empty)['total']) == 0.0
    assert state.step == 2 and state.optimizer.count == 1
    for k, v in tsys.net.named_parameters():
        assert torch.equal(v, params[k]), k
    assert any(not torch.equal(v, buffers[k]) for k, v in tsys.net.named_buffers()
               if v.is_floating_point())


@pytest.mark.parametrize('name', HEADS)
def test_f64_reference_step_matches_f32(priors, name):
    """The reference of the card's step parity (``chip_smoke.py``): the
    same step with the network in f64 (the images and P2 cast by the apply
    function; the flax-style BatchNorm, ``FlaxConv2d``, ``LookGround`` and
    the plain DCN in f64), the trunk's residual branches damped as there.
    Its loss terms within rtol 1e-5 and its gradients within 1e-3
    norm-wise of the f32 step's: f32 rounding, grown through the
    BatchNorm backward of a random network (0.03% here; at full size the
    card's f32 step sits 0.05% from the f64 one, the CPU's 0.1-0.35%); a
    different function would be off by its whole size."""
    tsys = DETECTOR_DICT[name](_cfg(priors, name), device='cpu')
    rng = np.random.default_rng(13)
    images = _t(rng.standard_normal((BATCH, *IMAGE_HW, 3)).astype(np.float32))
    P2 = sample_P2(BATCH)
    ann = _t(_anchor_annotations(tsys, P2, rng))
    with torch.no_grad():  # the residual branches damped, as chip_smoke.py's parity damps them
        for m in tsys.net.modules():
            if isinstance(m, BasicBlock):
                m.BatchNorm_1.weight.mul_(0.1)
    testing.prepare_mono_for_training(tsys, images, _t(P2), torch.Generator().manual_seed(14),
                                      offset_std=0.5)
    tsys.dropout = False
    init = copy.deepcopy(tsys.net.state_dict())
    out = {}
    for dtype, apply_fn in ((torch.float32, None),
                            (torch.float64, lambda net, x, P2: net(x.double(), P2=P2.double()))):
        tsys.net.load_state_dict(init)
        tsys.net.to(dtype).zero_grad()
        cls_loss, reg_loss, _ = tsys.loss(images, _t(P2), ann, apply_fn=apply_fn)
        (cls_loss.mean() + reg_loss.mean()).backward()
        assert all(p.dtype == dtype for p in tsys.net.parameters())
        out[dtype] = (float(cls_loss.detach()), float(reg_loss.detach()),
                      torch.cat([p.grad.double().ravel() for p in tsys.net.parameters()]))
    (c32, r32, g32), (c64, r64, g64) = out[torch.float32], out[torch.float64]
    assert r64 > 0
    np.testing.assert_allclose([c32, r32], [c64, r64], rtol=1e-5)
    assert float((g32 - g64).norm() / g64.norm()) <= 1e-3


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    """Without CUDA the default device raises (no quiet CPU fallback), and
    an unknown head is refused; the GAC config is configs/yolo3d_gac.py's."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry.build_gac_system()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry.build_gac_trainer(compute_dtype='bfloat16')
    with pytest.raises(ValueError, match='head'):
        entry.build_gac_system(device='cpu', head='retina')
    cfg = testing.gac_detector_cfg('/nonexistent', name='Yolo3D')
    assert cfg.name == 'Yolo3D' and cfg.backbone.depth == 101 and cfg.backbone.s2d_stem
    assert (cfg.head.layer_cfg.cls_feature_size, cfg.head.layer_cfg.reg_feature_size) == (512, 1024)
    train = testing.gac_train_cfg()
    assert train.optimizer.clipped_gradient_norm == 0.1
    assert dict(train.scheduler.keywords) == {'T_max': 30, 'eta_min': 3e-5}


def test_km3d_resnet_core_message_points_at_the_roadmap():
    with pytest.raises(NotImplementedError, match='Queue A, A3 item 1'):
        KM3DCore({'name': 'resnet'})
