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


def _kernel_formulation(x, offset, mask, weight, grad, stride=1, padding=1, dilation=1,
                        radius=None):
    """The backward kernels' arithmetic written in torch (f32): per tap,
    ds = dy . W_k^T, the four corner gradients scattered into dx, the four
    lerp-weight gradients summed over channels and carried to d_offset and
    d_mask by ``_lerp_weights`` under autograd, dW from the sampled values
    rounded as the forward rounds them. With ``radius``, the dx kernel's
    window: a corner that lands in the window of its pixel's tile
    (``dc.dx_plan``, ``dc.dx_window``) is added there, any other into dx
    (the spill), and every tile's window is then added into dx (the flush),
    only its cells inside the image."""
    b, h, w, c = x.shape
    kh, kw, _, co = weight.shape
    ho, wo = dc.output_hw(h, w, kh, kw, stride, padding, dilation)
    if radius is not None:
        th, tw = dc.dx_plan(ho, wo)
        win_h, win_w = dc.dx_window((th, tw), kh, kw, stride, dilation, radius)
        tiles_y, tiles_x = -(-ho // th), -(-wo // tw)
        oy = torch.arange(ho).view(ho, 1).expand(ho, wo).reshape(-1)
        ox = torch.arange(wo).view(1, wo).expand(ho, wo).reshape(-1)
        tile = (oy // th) * tiles_x + ox // tw          # [P]
        org_y = (oy // th) * th * stride - padding - radius  # the tile's window origin
        org_x = (ox // tw) * tw * stride - padding - radius
        win = torch.zeros(b, tiles_y * tiles_x * win_h * win_w, c)
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
            if radius is None:
                dx.scatter_add_(1, idx, d * inside)
                continue
            yy, xx = idx[..., 0] // w, idx[..., 0] % w  # inside corners: their own pixel
            ry, rx = yy - org_y, xx - org_x
            in_win = ((ry >= 0) & (ry < win_h) & (rx >= 0) & (rx < win_w)).unsqueeze(-1)
            cell = ((tile * win_h) + ry.clamp(0, win_h - 1)) * win_w + rx.clamp(0, win_w - 1)
            win.scatter_add_(1, cell.unsqueeze(-1).expand(-1, -1, c), d * (inside & in_win))
            dx.scatter_add_(1, idx, d * (inside & ~in_win))
    if radius is not None:  # the flush: each window cell inside the image into dx
        t = torch.arange(tiles_y * tiles_x)
        y = ((t // tiles_x) * th * stride - padding - radius).view(-1, 1, 1) + \
            torch.arange(win_h).view(1, -1, 1)
        xw = ((t % tiles_x) * tw * stride - padding - radius).view(-1, 1, 1) + \
            torch.arange(win_w).view(1, 1, -1)
        inside = ((y >= 0) & (y < h) & (xw >= 0) & (xw < w)).reshape(-1)
        target = (y.clamp(0, h - 1) * w + xw.clamp(0, w - 1)).reshape(-1)
        dx.index_add_(1, target[inside], win[:, inside])
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


@pytest.mark.parametrize('conv', [{}, dict(stride=2), dict(padding=2, dilation=2)],
                         ids=['plain', 'stride2', 'dilation2'])
def test_kernel_window_formulation_equals_autograd(conv):
    """The dx kernel's window (2-D tiles of 64 output pixels, a window of
    +-R px in shared memory, the spill beyond it, the flush) equals autograd
    through the plain forward (f32, within 1e-5 of each gradient's max),
    with offsets that straddle R (uniform in +-(R + 1.5): some corners in
    the window, some spilled) on a map of clipped tiles."""
    r = dc.DX_WINDOW_RADIUS
    args, grad = _inputs(5, b=2, h=19, w=21, c_in=5, c_out=6, off_scale=r + 1.5, conv=conv)
    x, off, mask, weight, _ = (torch.from_numpy(a) for a in args)
    grad = torch.from_numpy(grad)
    ho, wo = off.shape[1:3]
    spill = dc.dx_window_spill(off, 19, 21, 5, **conv)
    assert spill['spilled'] > 0 and spill['window'] > 0, spill
    assert ho % dc.dx_plan(ho, wo)[0] or wo % dc.dx_plan(ho, wo)[1]  # a clipped tile
    ref = dc.modulated_deform_conv_backward_plain(x, off, mask, weight, grad, **conv)
    out = _kernel_formulation(x, off, mask, weight, grad, radius=r, **conv)
    for name, o, r_ in zip(NAMES, out, ref):
        assert o.shape == r_.shape and o.dtype == r_.dtype, name
        torch.testing.assert_close(o, r_, rtol=0, atol=1e-5 * float(r_.abs().max()), msg=name)


def test_dx_window_spill_counts_by_hand():
    """The device-memory adds of the dx kernel, counted by hand on a 24x24
    map (3x3 tiles of 8x8, windows of 19x19 from -5): zero offsets sample
    the integer grid, so per axis the corners y0 = o - 1 + k and y0 + 1
    fall inside the image 70 and 69 times and every corner lands in its
    window: (70 + 69)^2 corner adds a channel, none spilled, and per axis
    the tiles touch 10, 11 and 9 rows, (10 + 11 + 9)^2 window cells. One
    tap of pixel (0, 0) moved 16 px down samples rows 15 and 16 of column
    0 (column -1 is outside): two corners in the image, both outside its
    tile's window (rows -5..13), and its old corner (0, 0) lost."""
    c_in = 3
    off = torch.zeros((1, 24, 24, 18))
    got = dc.dx_window_spill(off, 24, 24, c_in)
    assert got['tile'] == (8, 8) and got['window_hw'] == (19, 19)
    assert got['corner_adds'] == 139 ** 2 * c_in and got['spilled'] == 0
    assert got['window'] == 30 ** 2 * c_in == got['global_adds']
    assert got['all_corners'] == 24 * 24 * 36 * c_in
    off[0, 0, 0, 0] = 16.0  # dy of tap 0 at pixel (0, 0)
    got = dc.dx_window_spill(off, 24, 24, c_in)
    assert got['spilled'] == 2 * c_in
    assert got['corner_adds'] == (139 ** 2 + 1) * c_in
    assert got['global_adds'] == (2 + 30 ** 2) * c_in


def test_dx_plan_takes_the_tile_with_fewer_blocks():
    assert dc.dx_plan(24, 80) == (8, 8)
    assert dc.dx_plan(12, 40) == (4, 16)  # 3 x 3 tiles of 4x16 against 2 x 5 of 8x8
    assert dc.dx_window((8, 8), 3, 3, 1, 1, 4) == (19, 19)
    assert dc.dx_window((8, 8), 3, 3, 2, 2, 4) == (28, 28)


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
