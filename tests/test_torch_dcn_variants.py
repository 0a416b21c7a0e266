"""The DCN forward variants of the port against the JAX package, on the CPU.

The JAX package's switches ``VD3D_DCN_PREMUL=1`` and ``VD3D_DCN_ALLTAPS=1``
send its bf16 DCNs to the Pallas kernels ``_lerp_accum_kernel`` (K6, after
the pre-multiplied table ``Y = x @ W'``) and ``_lerp_matmul_alltaps_kernel``
(K4); the port reads the same switches (``ops/deform_conv.forward_variant``).
Here: the port picks the variant the JAX gates pick across a grid of
shapes; the plain premul version against the JAX premul path and the port
under the all-taps switch against the JAX all-taps kernel (both in
interpret mode); the premul gradients against the JAX premul backward (the
pairs formulation's vjp); the all-taps forward's gradients against the
per-tap ones; and a small KM3D in bf16 with both switches set, whose 8 proj
DCNs take premul and 8 node DCNs all-taps on both sides. The JAX op reads
the switches at trace time, so each setting gets a fresh ``jax.jit``.

Tolerances. Forward, bf16, the per-tap kernel K3's gate
(``tests/test_torch_deform_conv.py``): every element within 3% of max|out|
and at least 99% within two bf16 ulps; the premul path is held tighter
(stated at the test). Gradients, bf16: the bound of
``tests/test_torch_deform_conv_grad.py``: each gradient's error to the f32
oracle (the JAX pairs path in f32 on the same bf16 values), as max|err| /
max|oracle|, at most 1.5x the JAX bf16 premul backward's own. KM3D bf16:
each raw map within a norm-wise 3e-2 of JAX's (``tests/test_torch_km3d.py``)
or, where more, 1.5x the JAX bf16 forward's own norm-wise distance to the
f32 forward. The second bound is the bf16 noise floor of this fixture: at
32x256 and batch 1 the per-tap path (both switches off) already differs
from JAX by 3.4% on the ``prob`` map, and JAX's bf16 from f32 by as much.
"""
import copy
import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualdet3d_tpu.registry import DETECTOR_DICT as JAX_DETECTORS
import visualdet3d_tpu.models.detectors.km3d  # noqa: F401
from visualdet3d_tpu_torch import testing
from visualdet3d_tpu_torch.config import EasyDict
from visualdet3d_tpu_torch.models.blocks import ModulatedDeformConv
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.registry import DETECTOR_DICT
import visualdet3d_tpu_torch.models  # noqa: F401
from test_torch_monoflex import flax_variables_from_port

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
jax_dc = importlib.import_module('visualdet3d_tpu.ops.deform_conv')

SWITCHES = {'off': {}, 'alltaps': {'VD3D_DCN_ALLTAPS': '1'},
            'premul': {'VD3D_DCN_PREMUL': '1'},
            'both': {'VD3D_DCN_ALLTAPS': '1', 'VD3D_DCN_PREMUL': '1'}}


def _switch(monkeypatch, setting):
    for key in ('VD3D_DCN_ALLTAPS', 'VD3D_DCN_PREMUL'):
        monkeypatch.delenv(key, raising=False)
    for key, value in SWITCHES[setting].items():
        monkeypatch.setenv(key, value)


def _jax_variant(hw, c_in, c_out, dtype, train):
    """The Pallas forward the JAX package's ``modulated_deform_conv`` takes
    (its gates, as the op applies them)."""
    if not train and jax_dc._premul_ok(hw, c_in, c_out, dtype):
        return 'premul'
    if jax_dc._packed_ok(hw, c_in, c_out, dtype) and \
            os.environ.get('VD3D_DCN_ALLTAPS') == '1' and \
            jax_dc._pick_pixrows_alltaps(hw, c_in, c_out, 9) is not None:
        return 'alltaps'
    return 'per_tap'


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _inputs(rng, b, h, w, c_in, c_out, off_scale):
    x = rng.standard_normal((b, h, w, c_in)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, c_in, c_out)) * 0.1).astype(np.float32)
    offset = rng.uniform(-off_scale, off_scale, (b, h, w, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, h, w, 9)).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    # bf16-representable, so that both frameworks take the same inputs
    return [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
            for a in (x, offset, mask, weight, bias)]


def _jax_forward(args, **kw):
    """The JAX op on bf16 inputs, traced now (under the switches as set)."""
    fn = jax.jit(lambda *a: jax_dc.modulated_deform_conv(*a, **kw))
    return np.asarray(fn(*[jnp.asarray(a, jnp.bfloat16) for a in args]), np.float32)


def _bf16(args):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in args]


# --------------------------------------------------------------------------
# the choice
# --------------------------------------------------------------------------

GRID_HW = (100, 128, 480, 1920, 7680)   # 100: not a multiple of 8
GRID_CHANNELS = ((512, 256), (256, 256), (256, 128), (256, 64), (128, 128), (128, 64),
                 (64, 64), (64, 128), (96, 32), (512, 512), (128, 96), (1024, 64))


@pytest.mark.parametrize('setting', sorted(SWITCHES))
def test_port_picks_the_variant_the_jax_gates_pick(monkeypatch, setting):
    """C_out >= C_in, C_out % 64 != 0, C_in % 64 != 0, tap weights past
    4 MiB (512->512), f32, train=True and a pixel count that is not a
    multiple of 8 are in the grid; each variant is reached."""
    _switch(monkeypatch, setting)
    seen = set()
    for hw in GRID_HW:
        for c_in, c_out in GRID_CHANNELS:
            for tdtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
                for train in (False, True):
                    want = _jax_variant(hw, c_in, c_out, jdtype, train)
                    got = dc.forward_variant(hw, c_in, c_out, tdtype, train)
                    assert got == want, (setting, hw, c_in, c_out, tdtype, train)
                    seen.add(got)
    expected = {'off': {'per_tap'}, 'alltaps': {'per_tap', 'alltaps'},
                'premul': {'per_tap', 'premul'}, 'both': {'per_tap', 'alltaps', 'premul'}}
    assert seen == expected[setting]


# --------------------------------------------------------------------------
# the forward variants against the JAX kernels (interpret mode)
# --------------------------------------------------------------------------

def test_premul_plain_matches_jax_premul(monkeypatch):
    """bf16, b=1, 8x16, 128->64 (the shape of ``tests/test_ops.py``'s premul
    gate). Tighter than K3's gate, and holding: every element within two
    bf16 ulps of JAX's plus 1e-3 of max|out| (both lerp and accumulate in
    f32 without rounding the sample, so they differ by the table's and the
    sums' summation orders only)."""
    _switch(monkeypatch, 'premul')
    b, h, w, c_in, c_out = 1, 8, 16, 128, 64
    assert jax_dc._premul_ok(h * w, c_in, c_out, jnp.bfloat16), 'must take K6 on the JAX side'
    args = _inputs(np.random.default_rng(0), b, h, w, c_in, c_out, off_scale=3.0)
    ref = _jax_forward(args)
    plain = dc.modulated_deform_conv_premul_plain(*_bf16(args))
    out = dc.modulated_deform_conv(*_bf16(args))
    assert torch.equal(out, plain)  # the op takes the premul path on the CPU
    assert dc.LAUNCHES['modulated_deform_conv_premul_accum'] == 0
    out = out.float().numpy()
    scale = np.abs(ref).max()
    assert np.all(np.abs(out - ref) <= 2 * _bf16_ulp(ref) + 1e-3 * scale)
    # premul rounds differently from the per-tap path: the sample is not
    # rounded to bf16 before the tap weights
    per_tap = dc.modulated_deform_conv_plain(*_bf16(args)).float().numpy()
    assert np.abs(per_tap - out).max() > 0


def test_premul_lerp_accumulate_composes_the_table():
    """The premul plain version is its table followed by its lerp-accumulate
    (the split the card runs as cuBLAS + K6), and with zero offsets and a
    unit mask it is a plain 3x3 conv of the table's products."""
    args = _bf16(_inputs(np.random.default_rng(1), 2, 5, 7, 64, 16, off_scale=2.0))
    x, offset, mask, weight, bias = args
    y = dc.premul_table_plain(x, weight)
    assert y.shape == (2, 5, 7, 9 * 16) and y.dtype == torch.bfloat16
    assert torch.equal(dc.premul_lerp_accumulate(y, offset, mask, bias),
                       dc.modulated_deform_conv_premul_plain(*args))
    zero, ones = torch.zeros_like(offset), torch.ones_like(mask)
    out = dc.premul_lerp_accumulate_plain(y, zero, ones).float()
    yk = torch.nn.functional.pad(y.float().reshape(2, 5, 7, 9, 16), (0, 0, 0, 0, 1, 1, 1, 1))
    ref = sum(yk[:, i:i + 5, j:j + 7, 3 * i + j] for i in range(3) for j in range(3))
    assert torch.allclose(out, ref, rtol=1e-2, atol=1e-2)


def test_alltaps_matches_jax_alltaps(monkeypatch):
    _switch(monkeypatch, 'alltaps')
    b, h, w, c_in, c_out = 1, 8, 16, 64, 128
    assert jax_dc._packed_ok(h * w, c_in, c_out, jnp.bfloat16)
    assert jax_dc._pick_pixrows_alltaps(h * w, c_in, c_out, 9) is not None, 'must take K4'
    args = _inputs(np.random.default_rng(2), b, h, w, c_in, c_out, off_scale=3.0)
    ref = _jax_forward(args)
    assert dc.forward_variant(h * w, c_in, c_out, torch.bfloat16) == 'alltaps'
    out = dc.modulated_deform_conv(*_bf16(args))
    assert torch.equal(out, dc.modulated_deform_conv_alltaps(*_bf16(args)))
    out = out.float().numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=0.03 * scale)
    assert np.mean(np.abs(out - ref) <= 2 * _bf16_ulp(ref)) > 0.99


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

def _jax_grads(args, grad, dtype, train, **env):
    """jax.grad of sum(out * grad) w.r.t. x, offset, mask, weight, bias,
    traced under ``env``."""
    fn = jax.jit(jax.grad(
        lambda *a: jnp.sum(jax_dc.modulated_deform_conv(*a, train=train).astype(jnp.float32)
                           * grad), argnums=(0, 1, 2, 3, 4)))
    return [np.asarray(g, np.float64) for g in fn(*[jnp.asarray(a, dtype) for a in args])]


def _port_grads(args, grad, train):
    leaves = [t.detach().requires_grad_() for t in _bf16(args)]
    out = dc.modulated_deform_conv(*leaves, train=train)
    (out.float() * torch.from_numpy(grad)).sum().backward()
    return [t.grad.double().numpy() for t in leaves]


def test_premul_gradients_match_the_jax_premul_backward(monkeypatch):
    b, h, w, c_in, c_out = 1, 8, 16, 128, 64
    args = _inputs(np.random.default_rng(3), b, h, w, c_in, c_out, off_scale=3.0)
    grad = np.asarray(jnp.asarray(np.random.default_rng(4).standard_normal(
        (b, h, w, c_out)), jnp.bfloat16), np.float32)
    _switch(monkeypatch, 'off')
    oracle = _jax_grads(args, grad, jnp.float32, train=True)  # f32: the pairs path
    _switch(monkeypatch, 'premul')
    assert jax_dc._premul_ok(h * w, c_in, c_out, jnp.bfloat16)
    g_jax = _jax_grads(args, grad, jnp.bfloat16, train=False)
    g_port = _port_grads(args, grad, train=False)
    for name, gp, gj, go in zip(('dx', 'd_offset', 'd_mask', 'd_weight', 'd_bias'),
                                g_port, g_jax, oracle):
        scale = np.abs(go).max() + 1e-9
        floor = np.abs(gj - go).max() / scale  # the JAX premul backward's own error
        err = np.abs(gp - go).max() / scale
        assert err <= max(1.5 * floor, 1e-6), (name, err, floor)


def test_alltaps_forward_and_k7_backward_give_the_per_tap_gradients(monkeypatch):
    """Training under the all-taps switch: the JAX package runs K4 forward
    and K7 backward, the port the all-taps forward with the DCN backward;
    each side's gradients equal its own per-tap ones exactly (the forward
    variant computes the same function; the backward is the same)."""
    b, h, w, c_in, c_out = 1, 8, 16, 64, 64
    args = _inputs(np.random.default_rng(5), b, h, w, c_in, c_out, off_scale=3.0)
    grad = np.asarray(jnp.asarray(np.random.default_rng(6).standard_normal(
        (b, h, w, c_out)), jnp.bfloat16), np.float32)
    grads = {}
    for setting in ('alltaps', 'off'):
        _switch(monkeypatch, setting)
        assert dc.forward_variant(h * w, c_in, c_out, torch.bfloat16, train=True) == (
            'alltaps' if setting == 'alltaps' else 'per_tap')
        grads[setting] = (_jax_grads(args, grad, jnp.bfloat16, train=True),
                          _port_grads(args, grad, train=True))
    for side in (0, 1):
        for a, p in zip(grads['alltaps'][side], grads['off'][side]):
            np.testing.assert_array_equal(a, p)


# --------------------------------------------------------------------------
# a small KM3D under both switches
# --------------------------------------------------------------------------

IMAGE_HW = (32, 256)   # DCN pixel counts 8, 32, 128, 512: all multiples of 8
@pytest.fixture(scope='module')
def km3d_pair():
    cfg = testing.km3d_detector_cfg(head_features=16, top_k=20)
    jsys = JAX_DETECTORS['KM3D'](EasyDict(copy.deepcopy(cfg)))
    tsys = DETECTOR_DICT['KM3D'](EasyDict(copy.deepcopy(cfg)), device='cpu')
    images = np.random.default_rng(7).standard_normal((1, *IMAGE_HW, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(8)
    testing.seed_offset_convs(tsys, gen, 1.0, torch.from_numpy(images))
    testing.calibrate_head_convs(tsys, torch.from_numpy(images), gen)
    shapes = jax.eval_shape(lambda k: jsys.init(k, IMAGE_HW), jax.random.PRNGKey(0))
    variables = flax_variables_from_port(shapes, tsys)
    assert tsys.load_flax_variables(variables) == []
    return jsys, variables, tsys, images


def test_km3d_bf16_under_both_switches_matches_jax(monkeypatch, km3d_pair):
    jsys, variables, tsys, images = km3d_pair
    _switch(monkeypatch, 'both')
    jsys.cfg.inference_dtype = tsys.cfg.inference_dtype = 'bfloat16'
    shapes, variants = [], []
    real_variant = dc.forward_variant

    def recording_variant(hw, c_in, c_out, dtype, train=False, taps=9):
        variants.append(real_variant(hw, c_in, c_out, dtype, train, taps))
        return variants[-1]
    monkeypatch.setattr(dc, 'forward_variant', recording_variant)
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append((inp[0].shape[2] * inp[0].shape[3],
                                             inp[0].shape[1], out.shape[1])))
        for m in tsys.net.modules() if isinstance(m, ModulatedDeformConv)]
    try:
        dc.reset_launch_counts()
        out = tsys.predict_raw(torch.from_numpy(images))
        bf16_vars, (jim,), _ = jsys._inference_cast(variables, [images])
        ref = jax.jit(lambda v, im: jsys.net.apply(v, im, train=False))(bf16_vars, jim)
    finally:
        for h in hooks:
            h.remove()
        jsys.cfg.inference_dtype = tsys.cfg.inference_dtype = 'float32'
    f32 = tsys.predict_raw(torch.from_numpy(images))
    assert set(dc.LAUNCHES.values()) == {0}  # CPU: the plain versions
    # the JAX side: the 8 proj DCNs (C_out < C_in) take K6, the 8 node DCNs K4
    assert len(shapes) == 16 and sorted({hw for hw, _, _ in shapes}) == [8, 32, 128, 512]
    jax_variants = [_jax_variant(hw, c_in, c_out, jnp.bfloat16, False)
                    for hw, c_in, c_out in shapes]
    assert [c_out < c_in for _, c_in, c_out in shapes].count(True) == 8
    assert jax_variants == ['premul' if c_out < c_in else 'alltaps' for _, c_in, c_out in shapes]
    assert variants[:16] == jax_variants  # the port took the same ones
    assert variants[16:] == ['per_tap'] * 16  # f32
    assert len(variants) == 32  # the bf16 forward and the f32 one
    for name in ref:
        r = np.asarray(ref[name], np.float32)
        assert out[name].dtype == torch.bfloat16
        err = np.linalg.norm(out[name].float().numpy() - r) / np.linalg.norm(r)
        floor = np.linalg.norm(r - f32[name].numpy()) / np.linalg.norm(f32[name].numpy())
        assert err <= max(3e-2, 1.5 * floor), (name, err, floor)
