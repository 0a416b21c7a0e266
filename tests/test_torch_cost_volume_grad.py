"""The correlation volume's backward in the port against the JAX package's
vjp, on the CPU.

The JAX package differentiates its correlation kernels through the XLA vjp
of ``correlation_volume_xla`` (``_corr_eyes_bwd``, ``_corr_tpu_bwd``); the
port's plain backward (``correlation_backward_plain`` and ``_eyes``) is
held against ``jax.vjp`` of that function here, and the CUDA kernel
against the plain backward on the card (``chip_smoke.py``). The kernel's
order of work (64-column tiles with their halos, g rows padded with zero
columns, 4-column groups, the walk over the D + 3 rows of a group's bands)
is written out in torch and held against the plain backward, and
``correlation_bwd_plan`` against cases worked out by hand.

Tolerances: f32 within 1e-5 of the largest |value| (only the order of the
D-term sums differs); bf16 within twice JAX's own bf16-to-f32 distance
(the port accumulates in f32 and rounds once, JAX's bf16 vjp rounds on the
way); the f32 transcription within 1e-6 of the largest |value|.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualdet3d_tpu.ops.cost_volume import correlation_volume_xla
from visualdet3d_tpu_torch.ops import cost_volume as cv

# (B, H, W, C, D): what each reaches
SHAPES = {
    'tile': (2, 3, 64, 16, 8),          # one whole 64-column tile
    'ragged': (1, 2, 70, 32, 24),       # a second tile of 6 columns
    'disp_over_width': (2, 2, 5, 8, 12),  # W < D: the columns d >= W take no gradient
    'three_tiles': (1, 1, 150, 24, 30),   # halos across tiles, D = 30
}


def _inputs(shape, seed):
    b, h, w, c, d = shape
    rng = np.random.default_rng(seed)
    left, right = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, h, w, d)).astype(np.float32)
    return left, right, g


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_vjp_jit(left, right, g, num_disp):
    _, vjp = jax.vjp(lambda l, r: correlation_volume_xla(l, r, num_disp), left, right)
    return vjp(g)


def _jax_vjp(left, right, g, num_disp, dtype=jnp.float32):
    """jax.vjp of correlation_volume_xla in ``dtype`` (jitted: op by op its
    unrolled disparity loop takes seconds)."""
    dl, dr = _jax_vjp_jit(*(jnp.asarray(x, dtype) for x in (left, right, g)), num_disp)
    return np.asarray(dl, np.float32), np.asarray(dr, np.float32)


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_plain_backward_matches_jax_vjp_f32(name):
    b, h, w, c, d = SHAPES[name]
    left, right, g = _inputs(SHAPES[name], sum(SHAPES[name]))
    ref_l, ref_r = _jax_vjp(left, right, g, d)
    dl, dr = cv.correlation_backward_plain_eyes(*map(torch.from_numpy, (left, right, g)))
    for out, ref in ((dl, ref_l), (dr, ref_r)):
        assert out.dtype == torch.float32 and out.shape == (b, h, w, c)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # interleaved: dL in rows 2b, dR in rows 2b + 1
    both = np.stack([left, right], 1).reshape(2 * b, h, w, c)
    out = cv.correlation_backward_plain(torch.from_numpy(both), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(out[0::2], dl.numpy())
    np.testing.assert_array_equal(out[1::2], dr.numpy())
    if w < d:  # the zero columns of the volume take no gradient
        g2 = g.copy()
        g2[..., w:] = 1e3
        dl2, _ = cv.correlation_backward_plain_eyes(*map(torch.from_numpy, (left, right, g2)))
        np.testing.assert_array_equal(dl2.numpy(), dl.numpy())


@pytest.mark.parametrize('name', ['tile', 'ragged'])
def test_plain_backward_bf16_matches_jax_vjp(name):
    """bf16 in, bf16 out, one rounding of the f32 sums: its distance to
    JAX's f32 vjp at most twice that of JAX's own bf16 vjp."""
    b, h, w, c, d = SHAPES[name]
    left, right, g = _inputs(SHAPES[name], 7 + w)
    rounded = [torch.from_numpy(x).bfloat16() for x in (left, right, g)]
    ref32 = _jax_vjp(*(x.float().numpy() for x in rounded), d)
    ref16 = _jax_vjp(left, right, g, d, jnp.bfloat16)
    out = cv.correlation_backward_plain_eyes(*rounded)
    for o, r32, r16 in zip(out, ref32, ref16):
        assert o.dtype == torch.bfloat16
        jax_dist = np.abs(r16 - r32).max()
        assert 0 < jax_dist
        assert np.abs(o.float().numpy() - r32).max() <= 2 * jax_dist
        # one rounding of the f32 sums: within one bf16 ulp of them
        exact = torch.from_numpy(r32.copy())
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((o.float() - exact).abs() <= ulp + 1e-6 * exact.abs().max()).all())


def test_autograd_through_the_plain_forward_equals_the_plain_backward():
    """The plain forward differentiated op by op (no Function) and the plain
    backward: the same gradient, in both forms."""
    left, right, g = map(torch.from_numpy, _inputs(SHAPES['ragged'], 3))
    l = left.clone().requires_grad_()
    r = right.clone().requires_grad_()
    cv.correlation_volume_plain(l, r, g.shape[-1]).backward(g)
    dl, dr = cv.correlation_backward_plain_eyes(left, right, g)
    torch.testing.assert_close(l.grad, dl, rtol=0, atol=1e-6)
    torch.testing.assert_close(r.grad, dr, rtol=0, atol=1e-6)
    # the wrappers' Functions on the CPU: the plain backward exactly
    both = torch.stack([left, right], 1).flatten(0, 1).requires_grad_()
    cv.correlation_volume_interleaved(both, g.shape[-1]).backward(g)
    assert torch.equal(both.grad, cv.correlation_backward_plain(both.detach(), g))
    l2, r2 = left.clone().requires_grad_(), right.clone().requires_grad_()
    cv.correlation_volume(l2, r2, g.shape[-1]).backward(g)
    assert torch.equal(l2.grad, dl) and torch.equal(r2.grad, dr)


@pytest.mark.parametrize('w,num_disp', [(10, 4), (5, 8)], ids=['w10', 'disp_over_width'])
def test_gradcheck_f64(w, num_disp):
    gen = torch.Generator().manual_seed(w)
    both = torch.randn((4, 2, w, 6), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: cv.correlation_volume_interleaved(x, num_disp),
                                    (both,))
    l, r = (torch.randn((2, 2, w, 6), generator=gen, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    assert torch.autograd.gradcheck(lambda a, b: cv.correlation_volume(a, b, num_disp), (l, r))


def test_cpu_tensors_that_require_grad_take_the_plain_path_without_launching():
    cv.reset_launch_counts()
    both = torch.randn(4, 2, 8, 4, requires_grad=True)
    vol = cv.correlation_volume_interleaved(both, 3)
    assert vol.grad_fn is not None
    vol.sum().backward()
    left = torch.randn(2, 2, 8, 4, requires_grad=True)
    cv.correlation_volume(left, torch.randn(2, 2, 8, 4), 3).sum().backward()
    assert left.grad is not None
    assert set(cv.LAUNCHES.values()) == {0}


def test_non_cpu_tensors_never_take_the_plain_path():
    """Only CPU tensors select the plain versions; any other device reaches
    the kernels' checks (here: not CUDA, so they raise), with or without
    grad."""
    both = torch.empty(4, 2, 8, 4, device='meta', requires_grad=True)
    with pytest.raises(ValueError, match='CUDA'):
        cv.correlation_volume_interleaved(both, 3)
    with pytest.raises(ValueError, match='CUDA'):
        cv.correlation_volume(both[0::2], both[1::2], 3)
    g = torch.empty(2, 2, 8, 3, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        cv.correlation_backward_interleaved(both.detach(), g)
    with pytest.raises(ValueError, match='CUDA'):
        cv.correlation_backward(both.detach()[0::2], both.detach()[1::2], g)


def test_the_function_hands_the_backward_a_dense_gradient(monkeypatch):
    """The volume is read downstream as a channels_last NCHW tensor, so the
    gradient autograd hands back can be a strided view; the Function makes
    it dense before the backward (which the kernel reads as dense)."""
    seen = []
    plain = cv.correlation_backward_plain

    def recording(both, g):
        seen.append(g.is_contiguous())
        return plain(both, g)
    monkeypatch.setattr(cv, 'correlation_backward_plain', recording)
    both = torch.randn(4, 3, 9, 8, requires_grad=True)
    vol = cv.correlation_volume_interleaved(both, 5)
    weight = torch.randn(2, 5, 3, 9)  # NCHW contiguous: its [B, H, W, D] view is strided
    (vol.permute(0, 3, 1, 2).contiguous() * weight).sum().backward()
    assert seen == [True]
    ref = plain(both.detach(), weight.permute(0, 2, 3, 1).contiguous())
    assert torch.equal(both.grad, ref)


# --------------------------------------------------------------------------
# the kernel's order of work, written out in torch
# --------------------------------------------------------------------------

def _kernel_order(left, right, g):
    """``correlation_bwd_kernel`` for one dtype, in torch: per (pair, row,
    64-column tile) the staged rows (L from w0, R from w0 - D + 1, g from
    w0, zero outside the image), g's rows padded with zero columns; per
    128-byte channel chunk, 16 groups of 4 columns walking m = 0 .. D + 2,
    row k = 4 cg + m of L and R, g read at gl_base[i S + i - m] (dL) and
    gr_base[m S + m - i] (dR); the sums scaled by 1/C."""
    b, h, w, c = left.shape
    d = g.shape[-1]
    plan = cv.correlation_bwd_plan(w, c, d, left.dtype)
    rows, s, pad, cchunk = plan['rows'], plan['gstride'], cv.CORR_BWD_GPAD, plan['c_chunk']
    lf, rf, gf = left.float(), right.float(), g.float()
    dl, dr = torch.zeros(b, h, w, c), torch.zeros(b, h, w, c)
    for bi in range(b):
        for hi in range(h):
            for w0, _ in plan['tiles']:
                gs = torch.zeros(rows, s)
                n = max(0, min(rows, w - w0))
                gs[:n, pad:pad + d] = gf[bi, hi, w0:w0 + n]
                gs = gs.flatten()
                for cc in range(plan['n_cc']):
                    c0, c1 = cc * cchunk, min(c, (cc + 1) * cchunk)
                    ls, rs = torch.zeros(rows, cchunk), torch.zeros(rows, cchunk)
                    for k in range(rows):
                        if w0 + k < w:
                            ls[k, :c1 - c0] = lf[bi, hi, w0 + k, c0:c1]
                        if 0 <= w0 - (d - 1) + k < w:
                            rs[k, :c1 - c0] = rf[bi, hi, w0 - (d - 1) + k, c0:c1]
                    for cg in range(16):
                        acc_l, acc_r = torch.zeros(4, cchunk), torch.zeros(4, cchunk)
                        gl_base, gr_base = 4 * cg * s + d - 1 + pad, 4 * cg * s + pad
                        for m in range(d + 3):
                            k = 4 * cg + m
                            for i in range(4):
                                acc_l[i] += gs[gl_base + i * s + i - m] * rs[k]
                                acc_r[i] += gs[gr_base + m * s + m - i] * ls[k]
                        for i in range(4):
                            col = w0 + 4 * cg + i
                            if col < w:
                                dl[bi, hi, col, c0:c1] = acc_l[i, :c1 - c0] / c
                                dr[bi, hi, col, c0:c1] = acc_r[i, :c1 - c0] / c
    return dl, dr


@pytest.mark.parametrize('shape', [(1, 1, 70, 40, 24), (1, 2, 5, 8, 12), (1, 1, 33, 12, 7)],
                         ids=['ragged_two_chunks', 'disp_over_width', 'c12_d7'])
def test_kernel_order_of_work_matches_the_plain_backward(shape):
    left, right, g = map(torch.from_numpy, _inputs(shape, 11))
    ref = cv.correlation_backward_plain_eyes(left, right, g)
    out = _kernel_order(left, right, g)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-6 * float(r.abs().max()))


def test_bwd_plan_by_hand():
    p = cv.correlation_bwd_plan(320, 64, 24, torch.bfloat16)
    assert p['tiles'] == [(0, 64), (64, 64), (128, 64), (192, 64), (256, 64)]
    # 87 rows; g rows of 24 + 6 = 30 floats (4 x 30 = 120 = 24 mod 32: the
    # groups of a warp on banks 0, 24, 16, 8)
    assert (p['rows'], p['gstride'], p['c_chunk'], p['n_cc'], p['vec']) == (87, 30, 64, 1, True)
    # two stages of 2 x 87 x 128 bytes + 87 x 24 bf16 g values, and 87 x 30 floats
    assert p['smem'] == 2 * (2 * 87 * 128 + 4176) + 87 * 30 * 4 == 63336
    p = cv.correlation_bwd_plan(160, 128, 24, torch.float32)
    assert p['tiles'][-1] == (128, 32) and p['n_cc'] == 4 and p['c_chunk'] == 32
    assert p['smem'] == 2 * (2 * 87 * 128 + 87 * 24 * 4) + 87 * 30 * 4 == 71688
    # D = 26: 32 floats a row would put the groups on one bank; 33
    assert cv.correlation_bwd_plan(64, 8, 26, torch.float32)['gstride'] == 33
    assert not cv.correlation_bwd_plan(33, 12, 7, torch.bfloat16)['vec']  # C 12: no 16-byte pieces
    assert not cv.correlation_bwd_plan(5, 8, 3, torch.float32)['vec']  # W D 15
    with pytest.raises(ValueError, match='1 to 32'):
        cv.correlation_bwd_plan(64, 8, 33, torch.float32)
