"""The port's deformable conv against the JAX package, on the CPU.

The CUDA kernel cannot run here; its wrapper takes the plain PyTorch version
for CPU tensors, which these tests hold against the JAX reference: the
Pallas kernels K5 (f32) and K3 (bf16) in interpret mode, at shapes where
the JAX package's gates send the op to them (asserted), and the naive
per-corner formulation. On the card, ``chip_smoke.py`` holds the kernel
against the same plain version.

Tolerances: f32 3e-5 (the sum order of the K*C_in tap products differs
between the frameworks; the values are O(1)). bf16: the two frameworks
consume identical bf16 inputs and may differ by accumulation order and by
where XLA keeps excess precision at bf16 ulp scale, so 3% of max|out|, the
bound ``tests/test_ops.py`` reasons for two bf16 DCN formulations; most
elements are within two bf16 ulps.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from visualdet3d_tpu.models.blocks import ModulatedDeformConv as JaxModulatedDeformConv
from visualdet3d_tpu.ops.deform_conv import (
    _packed_f32_ok, _packed_ok, modulated_deform_conv as jax_mdc,
    modulated_deform_conv_reference as jax_mdc_reference)
from visualdet3d_tpu_torch import convert
from visualdet3d_tpu_torch.models.blocks import ModulatedDeformConv, channels_last_
from visualdet3d_tpu_torch.ops import deform_conv as dc

F32_ATOL = 3e-5


def _inputs(rng, b, h, w, c_in, c_out, off_scale, ho=None, wo=None, k=9):
    ho, wo = ho or h, wo or w
    x = rng.standard_normal((b, h, w, c_in)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, c_in, c_out)) * 0.1).astype(np.float32)
    offset = rng.uniform(-off_scale, off_scale, (b, ho, wo, 2 * k)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, ho, wo, k)).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    return x, offset, mask, weight, bias


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_plain_f32_matches_jax_k5():
    rng = np.random.default_rng(0)
    b, h, w, c_in, c_out = 2, 8, 16, 32, 48
    assert _packed_f32_ok(h * w, c_in, c_out, jnp.float32), 'must take K5 on the JAX side'
    args = _inputs(rng, b, h, w, c_in, c_out, off_scale=4.0)
    ref = np.asarray(jax.jit(jax_mdc)(*map(jnp.asarray, args)))
    out = dc.modulated_deform_conv(*map(torch.from_numpy, args)).numpy()
    assert out.shape == (b, h, w, c_out)
    np.testing.assert_allclose(out, ref, atol=F32_ATOL)


def test_plain_bf16_matches_jax_k3():
    rng = np.random.default_rng(1)
    b, h, w, c_in, c_out = 1, 8, 16, 64, 64
    assert _packed_ok(h * w, c_in, c_out, jnp.bfloat16), 'must take K3 on the JAX side'
    args = _inputs(rng, b, h, w, c_in, c_out, off_scale=3.0)
    ref = np.asarray(jax.jit(jax_mdc)(*[jnp.asarray(a, jnp.bfloat16) for a in args]),
                     np.float32)
    out = dc.modulated_deform_conv(*[torch.from_numpy(a).to(torch.bfloat16) for a in args])
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=0.03 * scale)
    assert np.mean(np.abs(out - ref) <= 2 * _bf16_ulp(ref)) > 0.99


@pytest.mark.parametrize('off_scale', [0.7, 3.0, 30.0])
def test_plain_matches_jax_reference_pairs_shape(off_scale):
    """c_in = 6: the JAX op takes its pairs path; the naive per-corner
    formulation is the reference. 30 px offsets put most samples wholly
    outside the image (output = bias)."""
    rng = np.random.default_rng(2)
    args = _inputs(rng, 2, 10, 14, 6, 5, off_scale)
    ref = np.asarray(jax_mdc_reference(*map(jnp.asarray, args)))
    out = dc.modulated_deform_conv(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(out, ref, atol=F32_ATOL)
    if off_scale == 30.0:
        assert np.mean(np.all(np.abs(out - args[4]) < 1e-6, axis=-1)) > 0.3


@pytest.mark.parametrize('stride,padding,dilation', [(2, 1, 1), (1, 2, 2)],
                         ids=['stride2', 'dilation2'])
def test_plain_matches_jax_reference_stride_dilation(stride, padding, dilation):
    rng = np.random.default_rng(3)
    ho, wo = dc.output_hw(10, 14, 3, 3, stride, padding, dilation)
    args = _inputs(rng, 2, 10, 14, 6, 5, 2.0, ho=ho, wo=wo)
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    ref = np.asarray(jax_mdc_reference(*map(jnp.asarray, args), **kw))
    out = dc.modulated_deform_conv(*map(torch.from_numpy, args), **kw).numpy()
    assert out.shape == ref.shape == (2, ho, wo, 5)
    np.testing.assert_allclose(out, ref, atol=F32_ATOL)


def test_samples_on_the_image_edge():
    """Samples at exactly -1 and H (every corner but one, or all, outside)
    and at H - 1 against the naive formulation."""
    rng = np.random.default_rng(4)
    x, _, mask, weight, bias = _inputs(rng, 1, 6, 7, 4, 3, 0.0)
    offset = np.zeros((1, 6, 7, 18), np.float32)
    # pixel (0, 0), tap (0, 0) sits at (-1, -1); move taps to rows -1, 6, 5
    offset[0, 0, 0, 0::2] = [0, 0, 0, -1, 0, 0, 6, 5, 4]
    offset[0, 3, 3, 1::2] = [-3, 3.5, 2, -1, 0, 0, 0.5, 0, 0]
    ref = np.asarray(jax_mdc_reference(*map(jnp.asarray, (x, offset, mask, weight, bias))))
    out = dc.modulated_deform_conv(*map(torch.from_numpy, (x, offset, mask, weight, bias)))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)


def test_zero_offsets_and_unit_mask_equal_a_conv():
    rng = np.random.default_rng(5)
    x, _, _, weight, bias = _inputs(rng, 2, 7, 9, 5, 4, 0.0)
    offset = np.zeros((2, 7, 9, 18), np.float32)
    out = dc.deform_conv(torch.from_numpy(x), torch.from_numpy(offset),
                         torch.from_numpy(weight), torch.from_numpy(bias))
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(weight).permute(3, 2, 0, 1), torch.from_numpy(bias),
                   padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_module_through_the_bridge_matches_jax():
    """``ModulatedDeformConv`` with the flax module's weights (its offset
    conv seeded: zero-initialised it would test no interpolation)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    jmod = JaxModulatedDeformConv(24, 3)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables['params'])
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    params['Conv_0'] = dict(kernel=(rng.standard_normal((3, 3, 16, 27)) * 0.5).astype(np.float32),
                            bias=rng.standard_normal(27).astype(np.float32))
    params['bias'] = rng.standard_normal(24).astype(np.float32)
    ref = np.asarray(jax.jit(jmod.apply)({'params': params}, jnp.asarray(x)))

    tmod = channels_last_(ModulatedDeformConv(16, 24, 3)).eval()
    assert convert.load_flax_variables(tmod, {'params': params}) == []
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = tmod(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_module_hands_the_kernel_strided_offsets():
    """The module's offset and mask are channel slices of the offset conv's
    NHWC output; the wrapper's layout check takes them, and refuses an NCHW
    tensor permuted to NHWC."""
    om = torch.randn(2, 27, 5, 6).contiguous(memory_format=torch.channels_last)
    om = om.permute(0, 2, 3, 1)
    assert dc.pixel_stride(om[..., :18], (2, 5, 6, 18), 'offset') == 27
    assert dc.pixel_stride(torch.sigmoid(om[..., 18:]), (2, 5, 6, 9), 'mask') in (9, 27)
    with pytest.raises(ValueError, match='NHWC'):
        dc.pixel_stride(torch.randn(2, 18, 5, 6).permute(0, 2, 3, 1), (2, 5, 6, 18), 'offset')


def test_cpu_tensors_take_the_plain_path_without_launching():
    rng = np.random.default_rng(7)
    args = [torch.from_numpy(a) for a in _inputs(rng, 1, 4, 5, 3, 2, 1.0)]
    dc.reset_launch_counts()
    assert torch.equal(dc.modulated_deform_conv(*args), dc.modulated_deform_conv_plain(*args))
    assert set(dc.LAUNCHES.values()) == {0}


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only CPU tensors select the plain version; any other device reaches
    the kernel's checks (here: not CUDA, so they raise)."""
    args = [torch.empty(s, device='meta') for s in
            ((1, 4, 5, 3), (1, 4, 5, 18), (1, 4, 5, 9), (3, 3, 3, 2))]
    with pytest.raises(ValueError, match='CUDA'):
        dc.modulated_deform_conv(*args)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        dc.modulated_deform_conv(*[a.half() for a in args])
