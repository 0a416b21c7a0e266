"""The port's int8 conv (kernel B8's plain version) against the JAX package,
on the CPU.

The CUDA kernels cannot run here; the wrappers take their plain PyTorch
versions for CPU tensors, which these tests hold against the JAX package:
the s32 sums of ``ops.int8_conv.int8_conv2d`` bit-equal to XLA's s8
``conv_general_dilated`` with s32 accumulation (and, at stride 2, to the
JAX package's space-to-depth form ``quant._s2d_conv_int8``), and the
``Int8Conv2d`` module on the representable grid equal to the f32 conv at
rtol = atol = 1e-5 (the JAX package's own gate; the only error left is the
f32 sum order). On the card, ``chip_smoke.py`` holds the kernels against
the same plain versions.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from visualdet3d_tpu.models import quant as jax_quant
from visualdet3d_tpu_torch.models.quant import Int8Conv2d, quantize_weight
from visualdet3d_tpu_torch.ops import int8_block as ib
from visualdet3d_tpu_torch.ops import int8_conv as ic


def _lax_s8_conv(xq, kq, stride, padding, dilation):
    return np.asarray(jax.jit(lambda x, k: jax.lax.conv_general_dilated(
        x, k, stride, padding, rhs_dilation=dilation,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32))(xq, kq))


CASES = [  # (k, stride, padding, dilation, h, w, c_in, c_out)
    (1, 1, 'SAME', 1, 9, 13, 64, 48),
    (3, 1, 'SAME', 1, 12, 20, 64, 64),
    (3, 1, [(1, 1), (1, 1)], 1, 7, 9, 72, 144),
    (3, 2, [(1, 1), (1, 1)], 1, 12, 20, 8, 16),
    (1, 2, 'SAME', 1, 12, 20, 8, 16),
    (3, 2, 'SAME', 1, 11, 19, 8, 16),
    (2, 2, [(0, 1), (1, 0)], 1, 10, 14, 8, 16),
    (3, 1, [(2, 2), (2, 2)], 2, 12, 20, 16, 24),
    (3, 1, 'SAME', 2, 11, 13, 5, 7),
    (3, 1, [(0, 2), (1, 0)], 1, 6, 7, 13, 3),
]


@pytest.mark.parametrize('k,stride,padding,dilation,h,w,c_in,c_out', CASES)
def test_int8_conv_s32_sums_bit_equal_lax(k, stride, padding, dilation, h, w, c_in, c_out):
    rng = np.random.default_rng(k * 100 + h + c_in)
    xq = rng.integers(-127, 128, (2, h, w, c_in), dtype=np.int8)
    kq = rng.integers(-127, 128, (k, k, c_in, c_out), dtype=np.int8)
    span = (k - 1) * dilation + 1  # XLA's 'SAME' pads for the dilated window
    pad = tuple(map(tuple, jax.lax.padtype_to_pads((h, w), (span, span), (stride, stride), padding)
                    if padding == 'SAME' else padding))
    ref = _lax_s8_conv(xq, kq, (stride, stride), padding, (dilation, dilation))
    got = ic.int8_conv2d(torch.from_numpy(xq), torch.from_numpy(kq.transpose(3, 0, 1, 2).copy()),
                         (stride, stride), pad, (dilation, dilation))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if stride == 2 and dilation == 1:
        s2d = np.asarray(jax_quant._s2d_conv_int8(
            jnp.asarray(xq), jnp.asarray(kq),
            jax_quant._resolve_padding(padding, (h, w), (k, k), (2, 2))))
        np.testing.assert_array_equal(got.numpy(), s2d)


def test_int8_conv_epilogue_extremes():
    """+-127 everywhere at the widest K of the stereo path (9 x 1408): the
    exact s32 sum, then ``acc * scale + bias`` in f32 and in bf16."""
    xq = torch.full((1, 3, 4, 1408), 127, dtype=torch.int8)
    wq = torch.full((4, 3, 3, 1408), -127, dtype=torch.int8)
    acc = ic.int8_conv2d(xq, wq, padding=((1, 1), (1, 1)))
    assert int(acc[0, 1, 1, 0]) == -9 * 1408 * 127 * 127
    scale = torch.full((4,), 1e-6)
    bias = torch.arange(4, dtype=torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        y = ic.int8_conv2d(xq, wq, padding=((1, 1), (1, 1)), scale=scale, bias=bias, out_dtype=dt)
        assert y.dtype == dt
        ref = (acc.float() * scale + bias).to(dt)
        assert torch.equal(y, ref)


def test_int8_conv2d_module_exact_on_representable_grid():
    """Activations and weights that are exact multiples of their scales: the
    int8 module reproduces the f32 conv (the JAX package's gate)."""
    rng = np.random.default_rng(0)
    act_scale = 0.03
    x = torch.from_numpy((rng.integers(-127, 128, (2, 8, 16, 64)) * act_scale).astype(np.float32))
    w_scale = rng.uniform(1e-3, 2e-3, 64).astype(np.float32)
    w_int = rng.integers(-127, 128, (64, 64, 3, 3))
    w_int[:, 0, 0, 0] = 127  # pin each output channel's absmax to the grid
    conv = torch.nn.Conv2d(64, 64, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy((w_int * w_scale[:, None, None, None]).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(rng.standard_normal(64).astype(np.float32)))
    k_q, ws = quantize_weight(conv.weight)
    entry = {'kernel_q': k_q, 'w_scale': ws, 'act_scale': torch.tensor(np.float32(act_scale)),
             'bias': conv.bias.detach().clone()}
    x_nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out = Int8Conv2d(conv, entry, torch.float32)(x_nchw)
    ref = conv(x_nchw)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take():
    xq = torch.zeros((1, 4, 4, 64), dtype=torch.int8)
    wq = torch.zeros((64, 3, 3, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match='a scale goes with a float output'):
        ic.int8_conv2d(xq, wq, out_dtype=torch.float32)
    with pytest.raises(TypeError, match='out_dtype'):
        ic.int8_conv2d(xq, wq, out_dtype=torch.float16)
    with pytest.raises(TypeError, match='out_dtype'):
        ib.int8_basic_block(xq, wq, wq, torch.zeros((6, 64)), torch.int8)
    # a tensor on the CPU with another on a device is not the plain path
    with pytest.raises(ValueError, match='expected a CUDA tensor'):
        ic.int8_conv2d(xq, wq.to('meta'))


def test_block_plain_matches_the_reference_formula():
    """The plain fused block is the JAX package's reference formula
    (``_ref_block_dequant_residual``): quantize, s8 conv, f32 affine, ReLU,
    requantize by the reciprocal, s8 conv, affine, the dequantized residual,
    ReLU; here written out with F.conv2d on the integer values."""
    rng = np.random.default_rng(2)
    xq = torch.from_numpy(rng.integers(-30, 31, (2, 6, 9, 64), dtype=np.int8))
    w1, w2 = (torch.from_numpy(rng.integers(-127, 128, (64, 3, 3, 64), dtype=np.int8))
              for _ in range(2))
    p = torch.from_numpy(np.stack([
        rng.uniform(1e-5, 3e-5, 64), rng.standard_normal(64) * 0.1, np.full(64, 9.0),
        rng.uniform(1e-5, 3e-5, 64), rng.standard_normal(64) * 0.1, np.full(64, 0.02),
    ]).astype(np.float32))
    out = ib.int8_basic_block(xq, w1, w2, p, torch.float32)

    def conv(q, w):
        return F.conv2d(q.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(),
                        padding=1).permute(0, 2, 3, 1).float()

    h = torch.relu(conv(xq, w1) * p[0] + p[1])
    hq = torch.clamp(torch.round(h * p[2]), -127, 127)
    ref = torch.relu(conv(hq, w2) * p[3] + p[4] + xq.float() * p[5])
    assert torch.equal(out, ref)
