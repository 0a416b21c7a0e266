"""The port's ResNet trunk and stereo blocks against the JAX package, on
the CPU: JAX init, non-trivial BatchNorm statistics and affine parameters
set from numpy, the weight bridge, then both frameworks on the same input.

Tolerance rtol = atol = 1e-4 in f32: the frameworks add a conv's terms in
different orders (XLA CPU against oneDNN), and the difference grows through
the trunk's depth.
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualdet3d_tpu.models import blocks as jax_blocks
from visualdet3d_tpu_torch.convert import load_flax_variables
from visualdet3d_tpu_torch.models import blocks
from visualdet3d_tpu_torch.models.backbones import resnet

# the backbones package re-exports the factory under the module's name
jax_resnet = importlib.import_module('visualdet3d_tpu.models.backbones.resnet')
TOL = dict(rtol=1e-4, atol=1e-4)


def _nontrivial_bn(variables, rng):
    """Replace every BatchNorm's scale/bias/mean/var with seeded values."""
    def walk(params, stats):
        for key in params:
            if key.startswith('BatchNorm'):
                n = params[key]['scale'].shape[0]
                params[key] = dict(scale=rng.uniform(0.5, 1.5, n).astype(np.float32),
                                   bias=rng.normal(0, 0.1, n).astype(np.float32))
                stats[key] = dict(mean=rng.normal(0, 0.2, n).astype(np.float32),
                                  var=rng.uniform(0.5, 2.0, n).astype(np.float32))
            elif isinstance(params[key], dict):
                walk(params[key], stats.setdefault(key, {}))
    params = _to_dict(jax.tree.map(np.asarray, variables['params']))
    stats = _to_dict(jax.tree.map(np.asarray, variables.get('batch_stats', {})))
    walk(params, stats)
    return {'params': params, 'batch_stats': stats}


def _to_dict(tree):
    if hasattr(tree, 'items'):
        return {k: _to_dict(v) for k, v in tree.items()}
    return tree


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def test_resnet18_s2d_stem_matches_jax():
    rng = np.random.default_rng(0)
    cfg = dict(depth=18, num_stages=3, out_indices=(0, 1, 2), s2d_stem=True,
               norm_eval=True, dilations=(1, 1, 1))
    jnet = jax_resnet.resnet(**cfg)
    x = rng.standard_normal((2, 64, 160, 3)).astype(np.float32)
    variables = _nontrivial_bn(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jnet.apply(variables, jnp.asarray(x), train=False)

    tnet = resnet.resnet(**cfg).eval()
    assert load_flax_variables(tnet, variables) == []
    blocks.channels_last_(tnet)
    with torch.no_grad():
        out = tnet(_nchw(x).contiguous(memory_format=torch.channels_last))
    assert [o.shape[1] for o in out] == tnet.out_channels == [64, 128, 256]
    for o, r in zip(out, ref):
        assert o.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_nhwc(o), np.asarray(r), **TOL)


def test_convert_stem_to_s2d_matches_jax():
    w7 = np.random.default_rng(1).standard_normal((7, 7, 3, 8)).astype(np.float32)  # HWIO
    ref = jax_resnet.convert_stem_to_s2d(w7)  # [4, 4, 12, 8]
    out = resnet.convert_stem_to_s2d(torch.from_numpy(w7.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(out.numpy().transpose(2, 3, 1, 0), ref)


def test_s2d_stem_equals_strided_7x7_stem():
    """The converted 4x4 kernel on the space-to-depth image is the 7x7/s2
    conv, in the port alone (the channel order and F.pad(2, 1) agree)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 3, 16, 24)).astype(np.float32))
    w7 = torch.from_numpy(rng.standard_normal((8, 3, 7, 7)).astype(np.float32))
    ref = torch.nn.functional.conv2d(x, w7, stride=2, padding=3)
    s2d = torch.nn.functional.pad(resnet.space_to_depth(x), (2, 1, 2, 1))
    out = torch.nn.functional.conv2d(s2d, resnet.convert_stem_to_s2d(w7))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize('make', ['res_ghost', 'conv_bn_relu', 'basic_block_proj'])
def test_blocks_match_jax(make):
    rng = np.random.default_rng(3)
    c_in = 24
    if make == 'res_ghost':
        jmod = jax_blocks.ResGhostModule(72, 3, ratio=3)
        tmod = blocks.ResGhostModule(c_in, 72, 3, ratio=3)
    elif make == 'conv_bn_relu':
        jmod = jax_blocks.ConvBnReLU(40, (3, 3))
        tmod = blocks.ConvBnReLU(c_in, 40, (3, 3))
    else:
        jmod = jax_resnet.BasicBlock(32, stride=2)
        tmod = resnet.BasicBlock(c_in, 32, stride=2)
    x = rng.standard_normal((2, 9, 14, c_in)).astype(np.float32)
    variables = _nontrivial_bn(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    tmod.eval()
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        out = tmod(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), ref, **TOL)


def test_anchor_flatten_matches_nhwc_reshape():
    x = np.arange(2 * 3 * 4 * 6, dtype=np.float32).reshape(2, 3, 4, 6)  # NHWC, A*C = 6
    ref = np.asarray(jax_blocks.anchor_flatten(jnp.asarray(x), 3))
    out = blocks.anchor_flatten(_nchw(x), 3)
    np.testing.assert_array_equal(out.numpy(), ref)
