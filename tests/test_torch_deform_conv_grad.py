"""Gradients of the port's deformable conv against the JAX package, on the CPU.

The CUDA backward kernel cannot run here; on CPU tensors the port takes
the plain version under autograd, which these tests hold against
``jax.grad`` of the JAX op with ``train=True``: in f32 the JAX package
takes its pairs formulation; in bf16 its packed path, whose backward is the
Pallas kernel K7 (``_lerp_matmul_bwd_kernel``, interpret mode here).
``chip_smoke.py`` holds the kernel against the same plain backward on the
card. A torch transcription of the kernel's formulation (dx scattered per
corner, the four lerp-weight gradients carried to d_offset and d_mask by
``_lerp_weights``, dW from the bf16-rounded samples) is held against
autograd too.

Inputs are made from numpy seeds; the output gradient is a fixed random
tensor (bf16-representable in the bf16 cases). Tolerances:

* f32: every gradient within 1e-4 of its largest magnitude (the two
  frameworks sum the K * C_in tap products and the pixel sums of dW in
  different orders);
* bf16: the criterion of ``tests/test_ops.py`` for K7: each gradient's
  error to the JAX f32 oracle (the pairs path in f32 on the same
  bf16-valued inputs), as max|err| / max|oracle|, is at most 1.5x the
  error of the JAX bf16 pairs path, so the port adds no error beyond the
  bf16 noise floor; K7 itself is held to the same bound;
* f64 ``gradcheck`` of the plain path at its defaults.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualdet3d_tpu.ops.deform_conv import _packed_ok, modulated_deform_conv as jax_mdc
from visualdet3d_tpu_torch.ops import deform_conv as dc

NAMES = ('dx', 'd_offset', 'd_mask', 'd_weight', 'd_bias')


def _inputs(seed, b, h, w, c_in, c_out, off_scale, conv=None):
    conv = conv or {}
    rng = np.random.default_rng(seed)
    ho, wo = dc.output_hw(h, w, 3, 3, conv.get('stride', 1), conv.get('padding', 1),
                          conv.get('dilation', 1))
    x = rng.standard_normal((b, h, w, c_in)).astype(np.float32)
    offset = rng.uniform(-off_scale, off_scale, (b, ho, wo, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, ho, wo, 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, c_in, c_out)) * 0.05).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    grad = rng.standard_normal((b, ho, wo, c_out)).astype(np.float32)
    return (x, offset, mask, weight, bias), grad


def _jax_grads(args, grad, train_packed=True, **conv):
    """jax.grad of sum(out * grad) w.r.t. x, offset, mask, weight, bias."""
    os.environ['VD3D_DCN_TRAIN_PACKED'] = '1' if train_packed else '0'
    try:
        fn = jax.jit(jax.grad(
            lambda *a: jnp.sum(jax_mdc(*a, train=True, **conv).astype(jnp.float32) * grad),
            argnums=(0, 1, 2, 3, 4)))
        return [np.asarray(g, np.float64) for g in fn(*args)]
    finally:
        os.environ.pop('VD3D_DCN_TRAIN_PACKED')


def _port_grads_of(leaves, grad, **conv):
    leaves = [t.detach().requires_grad_() for t in leaves]
    out = dc.modulated_deform_conv(*leaves, **conv)
    (out.float() * grad).sum().backward()
    return [t.grad.double().numpy() for t in leaves]


SHAPES = {
    # the shape of tests/test_ops.py's K7 gate: 8x16 pixels, C 64, offsets +-3.5 px
    'neck': (dict(b=2, h=8, w=16, c_in=64, c_out=64, off_scale=3.5), {}),
    # an image smaller than the offsets reach: most samples partly or wholly outside
    'small_image': (dict(b=2, h=3, w=5, c_in=8, c_out=6, off_scale=6.0), {}),
}


@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_plain_grads_match_jax_f32(shape):
    kw, conv = SHAPES[shape]
    args, grad = _inputs(0, **kw, conv=conv)
    ref = _jax_grads([jnp.asarray(a) for a in args], jnp.asarray(grad), **conv)
    out = _port_grads_of([torch.from_numpy(a) for a in args], torch.from_numpy(grad), **conv)
    for name, o, r in zip(NAMES, out, ref):
        assert o.shape == r.shape, name
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_plain_grads_bf16_within_the_k7_noise_floor(shape):
    kw, conv = SHAPES[shape]
    args32, grad = _inputs(1, **kw, conv=conv)
    args16 = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in args32]
    grad = np.asarray(jnp.asarray(grad, jnp.bfloat16), np.float32)
    if shape == 'neck':
        assert _packed_ok(kw['h'] * kw['w'], kw['c_in'], kw['c_out'], jnp.bfloat16), \
            'the JAX bf16 training path must take K7 here'
    jb = [jnp.asarray(a, jnp.bfloat16) for a in args16]
    g_k7 = _jax_grads(jb, jnp.asarray(grad), train_packed=True, **conv)
    g_pairs = _jax_grads(jb, jnp.asarray(grad), train_packed=False, **conv)
    g_oracle = _jax_grads([jnp.asarray(a) for a in args16], jnp.asarray(grad),
                          train_packed=False, **conv)
    g_port = _port_grads_of([torch.from_numpy(a).to(torch.bfloat16) for a in args16],
                            torch.from_numpy(grad), **conv)
    for name, gp, gk, gq, go in zip(NAMES, g_port, g_k7, g_pairs, g_oracle):
        scale = np.abs(go).max() + 1e-9
        floor = np.abs(gq - go).max() / scale  # the bf16 pairs path's own error
        err = np.abs(gp - go).max() / scale
        err_k7 = np.abs(gk - go).max() / scale
        assert err <= max(1.5 * floor, 1e-6), (name, err, floor)
        assert err_k7 <= max(1.5 * floor, 1e-6), (name, err_k7, floor)


def test_plain_path_gradcheck_f64():
    """Autograd through the plain version against finite differences, f64,
    at a tiny shape with samples inside, across and outside the edge."""
    args, _ = _inputs(2, b=1, h=3, w=4, c_in=2, c_out=2, off_scale=2.5)
    leaves = tuple(torch.from_numpy(a).double().requires_grad_() for a in args)
    assert torch.autograd.gradcheck(dc.modulated_deform_conv, leaves, eps=1e-6, atol=1e-6)


def _kernel_formulation(x, offset, mask, weight, grad, stride=1, padding=1, dilation=1):
    """The backward kernels' arithmetic written in torch (f32): per tap,
    ds = dy . W_k^T, the four corner gradients scattered into dx, the four
    lerp-weight gradients summed over channels and carried to d_offset and
    d_mask by ``_lerp_weights`` under autograd, dW from the sampled values
    rounded as the forward rounds them."""
    b, h, w, c = x.shape
    kh, kw, _, co = weight.shape
    ho, wo = dc.output_hw(h, w, kh, kw, stride, padding, dilation)
    y0, x0, (wx0, wx1, wy0, wy1) = dc._lerp_weights(offset, mask, ho, wo, kh, kw, stride,
                                                    padding, dilation, x.dtype)
    y0, x0 = y0.clamp(-2, h).long(), x0.clamp(-2, w).long()
    flat = x.reshape(b, h * w, c).float()
    wk = weight.reshape(kh * kw, c, co).float()
    dy = grad.reshape(b, -1, co).float()
    dx = torch.zeros(b, h * w, c)
    dw = torch.zeros(kh * kw, c, co)
    dwts = torch.zeros(b, ho * wo, kh * kw, 4)
    for k in range(kh * kw):
        corners = []
        for yy, xx in ((y0[..., k], x0[..., k]), (y0[..., k], x0[..., k] + 1),
                       (y0[..., k] + 1, x0[..., k]), (y0[..., k] + 1, x0[..., k] + 1)):
            inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).reshape(b, -1, 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, -1, 1).expand(-1, -1, c)
            corners.append((torch.where(inside, flat.gather(1, idx), 0.0), idx, inside))
        (v0, i0, m0), (v1, i1, m1), (v2, i2, m2), (v3, i3, m3) = corners
        a0, a1 = wy0[..., k].reshape(b, -1, 1), wy1[..., k].reshape(b, -1, 1)
        e0, e1 = wx0[..., k].reshape(b, -1, 1), wx1[..., k].reshape(b, -1, 1)
        vx0, vx1 = v0 * a0 + v2 * a1, v1 * a0 + v3 * a1
        sampled = (vx0 * e0 + vx1 * e1).to(x.dtype).float()
        dw[k] = torch.einsum('bpc,bpo->co', sampled, dy)
        ds = dy @ wk[k].T
        dvx0, dvx1 = ds * e0, ds * e1
        dwts[:, :, k] = torch.stack([(ds * vx0).sum(-1), (ds * vx1).sum(-1),
                                     (dvx0 * v0 + dvx1 * v1).sum(-1),
                                     (dvx0 * v2 + dvx1 * v3).sum(-1)], -1)
        for idx, inside, d in ((i0, m0, dvx0 * a0), (i1, m1, dvx1 * a0),
                               (i2, m2, dvx0 * a1), (i3, m3, dvx1 * a1)):
            dx.scatter_add_(1, idx, d * inside)
    with torch.enable_grad():
        off = offset.detach().requires_grad_()
        msk = mask.detach().requires_grad_()
        _, _, weights = dc._lerp_weights(off, msk, ho, wo, kh, kw, stride, padding, dilation,
                                         x.dtype)
        d_off, d_mask = torch.autograd.grad(
            weights, (off, msk), dwts.reshape(b, ho, wo, kh * kw, 4).unbind(-1))
    return (dx.reshape(x.shape).to(x.dtype), d_off, d_mask,
            dw.to(weight.dtype).reshape(weight.shape))


@pytest.mark.parametrize('conv', [{}, dict(stride=2), dict(padding=2, dilation=2)],
                         ids=['plain', 'stride2', 'dilation2'])
def test_kernel_formulation_equals_autograd(conv):
    """What the CUDA backward computes, step by step, equals autograd
    through the plain forward (f32, within 1e-5 of each gradient's max)."""
    args, grad = _inputs(3, b=2, h=7, w=9, c_in=5, c_out=6, off_scale=3.0, conv=conv)
    x, off, mask, weight, _ = (torch.from_numpy(a) for a in args)
    grad = torch.from_numpy(grad)
    ref = dc.modulated_deform_conv_backward_plain(x, off, mask, weight, grad, **conv)
    out = _kernel_formulation(x, off, mask, weight, grad, **conv)
    for name, o, r in zip(NAMES, out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        torch.testing.assert_close(o, r, rtol=0, atol=1e-5 * float(r.abs().max()), msg=name)


def test_backward_wrapper_on_cpu_takes_the_plain_backward():
    args, grad = _inputs(4, b=1, h=4, w=5, c_in=3, c_out=2, off_scale=1.0)
    x, off, mask, weight, _ = (torch.from_numpy(a) for a in args)
    grad = torch.from_numpy(grad)
    dc.reset_launch_counts()
    out = dc.modulated_deform_conv_backward(x, off, mask, weight, grad)
    ref = dc.modulated_deform_conv_backward_plain(x, off, mask, weight, grad)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert set(dc.LAUNCHES.values()) == {0}


def test_backward_wrapper_refuses_non_cuda_tensors():
    """Only CPU tensors select the plain backward; others reach the
    kernel's checks, which refuse a tensor not on the card."""
    shapes = ((1, 4, 5, 3), (1, 4, 5, 18), (1, 4, 5, 9), (3, 3, 3, 2), (1, 4, 5, 2))
    with pytest.raises(ValueError, match='CUDA'):
        dc.modulated_deform_conv_backward(*[torch.empty(s, device='meta') for s in shapes])
