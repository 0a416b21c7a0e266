"""The f32 dx pass of the DCN backward, in the warp-specialised kernel's order, on the CPU.

The kernel (``deform_conv_bwd_input_ws_kernel`` in ``csrc/deform_conv.cu``)
runs on the card only. Its order of work is written out here in torch, f32:
2-D tiles of output pixels of one image (``dx_f32_plan``'s pixel count in
rows of ``dx_plan``'s width), per tile the stages (tap, then chunks of 64
input channels), per stage ``ds = dy . W_k^T`` summed over pieces of 32
output channels, the four-corner scatter of ds's gradients into dx, and
the four lerp-weight sums per (pixel, tap), kept across a tap's chunks and
written after its last chunk; d_offset and
d_mask then follow from those sums through ``_lerp_weights``, as the
wrapper carries them. It is held against the plain backward (autograd
through the plain forward) and against ``jax.grad`` of the JAX package's f32
op. The kernel's lane arithmetic (the 16-lane shuffle reduction of the four
sums, the transposing copies' lanes, the FMA groups' register tiles of a
stage) is transcribed and checked too, each against the line of the source
it copies.

Tolerances, f32: against the plain backward within 1e-5 of max|.| per
gradient (the same terms summed in another order); against JAX within
1e-4 of max|.| (the convention of ``tests/test_torch_deform_conv_grad.py``:
the frameworks sum the tap products in other orders).
"""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualdet3d_tpu.ops.deform_conv import modulated_deform_conv as jax_mdc
from visualdet3d_tpu_torch.ops import deform_conv as dc

SRC = pathlib.Path(dc.__file__).resolve().parent.parent / 'csrc' / 'deform_conv.cu'
CONVS = [{}, dict(stride=2), dict(padding=2, dilation=2)]
CONV_IDS = ['plain', 'stride2', 'dilation2']


def _inputs(seed, b, h, w, c_in, c_out, off_scale, conv):
    rng = np.random.default_rng(seed)
    ho, wo = dc.output_hw(h, w, 3, 3, conv.get('stride', 1), conv.get('padding', 1),
                          conv.get('dilation', 1))
    x = rng.standard_normal((b, h, w, c_in)).astype(np.float32)
    offset = rng.uniform(-off_scale, off_scale, (b, ho, wo, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, ho, wo, 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, c_in, c_out)) * 0.1).astype(np.float32)
    grad = rng.standard_normal((b, ho, wo, c_out)).astype(np.float32)
    return (x, offset, mask, weight), grad


def _dx_kernel_order(x, offset, mask, weight, grad, conv):
    """The f32 dx kernel's work in torch: returns (dx, d_offset, d_mask)."""
    b, h, w, c_in = x.shape
    kh, kw, _, c_out = weight.shape
    k_taps = kh * kw
    ho, wo = offset.shape[1:3]
    n_pix = ho * wo
    stride, padding, dilation = (conv.get('stride', 1), conv.get('padding', 1),
                                 conv.get('dilation', 1))
    tile, _, _ = dc.dx_f32_plan(c_out, k_taps)
    tw = dc.dx_plan(ho, wo)[1]  # 2-D tiles of tile / tw rows of tw pixels
    th = tile // tw
    ch, oc = dc.DX_F32_CHANNELS, dc.DX_F32_PIECE
    y0, x0, weights = dc._corners(offset, mask, h, w, kh, kw, stride, padding, dilation,
                                  x.dtype)
    y0, x0 = y0.reshape(b, n_pix, k_taps), x0.reshape(b, n_pix, k_taps)
    wts = [t.reshape(b, n_pix, k_taps) for t in weights]  # 1-fx, fx, (1-fy)m, fy m
    flat = x.reshape(b, h * w, c_in)
    dy = grad.reshape(b, n_pix, c_out)
    wk = weight.reshape(k_taps, c_in, c_out)
    dx = torch.zeros(b, h * w, c_in)
    dwts = torch.full((b, n_pix, k_taps, 4), float('nan'))
    for bi in range(b):
        for oy0 in range(0, ho, th):
            for ox0 in range(0, wo, tw):
                oy, ox = torch.meshgrid(torch.arange(oy0, oy0 + th), torch.arange(ox0, ox0 + tw),
                                        indexing='ij')
                keep = (oy < ho) & (ox < wo)  # pixels past the map have no samples
                ps = (oy * wo + ox)[keep]
                sums = torch.zeros(len(ps), k_taps, 4)  # live across a tap's chunks
                for k in range(k_taps):
                    wx0, wx1, wy0, wy1 = (t[bi, ps, k, None] for t in wts)
                    corners = []
                    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):  # (y0,x0) (y0,x0+1) ..
                        yy, xx = y0[bi, ps, k] + cy, x0[bi, ps, k] + cx
                        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                        corners.append((inside, yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)))
                    for c0 in range(0, c_in, ch):  # a stage
                        cs = slice(c0, min(c_in, c0 + ch))
                        ds = torch.zeros(len(ps), cs.stop - cs.start)
                        for o0 in range(0, c_out, oc):  # the W pieces, in order
                            os_ = slice(o0, min(c_out, o0 + oc))
                            ds += dy[bi, ps, os_] @ wk[k, cs, os_].T
                        v = [torch.where(inside[:, None], flat[bi, idx][:, cs], 0.0)
                             for inside, idx in corners]
                        vx0 = v[0] * wy0 + v[2] * wy1
                        vx1 = v[1] * wy0 + v[3] * wy1
                        dvx0, dvx1 = ds * wx0, ds * wx1
                        sums[:, k, 0] += (ds * vx0).sum(1)
                        sums[:, k, 1] += (ds * vx1).sum(1)
                        sums[:, k, 2] += (dvx0 * v[0] + dvx1 * v[1]).sum(1)
                        sums[:, k, 3] += (dvx0 * v[2] + dvx1 * v[3]).sum(1)
                        for (inside, idx), d in zip(corners, (dvx0 * wy0, dvx1 * wy0,
                                                              dvx0 * wy1, dvx1 * wy1)):
                            dx[bi, :, cs] = dx[bi, :, cs].index_add(0, idx[inside], d[inside])
                    dwts[bi, ps, k] = sums[:, k]  # after the tap's last chunk
    assert not torch.isnan(dwts).any(), 'the tiles must cover every pixel'
    off = offset.detach().clone().requires_grad_()
    msk = mask.detach().clone().requires_grad_()
    _, _, lw = dc._lerp_weights(off, msk, ho, wo, kh, kw, stride, padding, dilation, x.dtype)
    d_offset, d_mask = torch.autograd.grad(lw, (off, msk),
                                           dwts.reshape(b, ho, wo, k_taps, 4).unbind(-1))
    return dx.reshape(b, h, w, c_in), d_offset, d_mask


def _check_against_plain(args, grad, conv):
    x, off, mask, weight = (torch.from_numpy(a) for a in args)
    grad = torch.from_numpy(grad)
    got = _dx_kernel_order(x, off, mask, weight, grad, conv)
    ref = dc.modulated_deform_conv_backward_plain(x, off, mask, weight, grad, **conv)[:3]
    for name, g, r in zip(('dx', 'd_offset', 'd_mask'), got, ref):
        assert g.shape == r.shape and not torch.isnan(g).any(), name
        assert float(r.abs().max()) > 0, name
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * float(r.abs().max()), msg=name)
    return got


@pytest.mark.parametrize('conv', CONVS, ids=CONV_IDS)
def test_dx_kernel_order_equals_plain(conv):
    """9 x 16 output pixels an image at stride 1: 4 x 16 tiles (dx_plan),
    the last clipped to one row; C_in 72: two chunks, the second of 8 channels;
    C_out 70: three W pieces, the last of 6 channels; offsets up to 3 px,
    some samples outside the image."""
    args, grad = _inputs(11, b=2, h=9, w=16, c_in=72, c_out=70, off_scale=3.0, conv=conv)
    _check_against_plain(args, grad, conv)


def test_dx_kernel_order_odd_c_in():
    """C_in 33 (the kernel's scalar path: one ragged chunk), C_out 5."""
    args, grad = _inputs(12, b=2, h=7, w=9, c_in=33, c_out=5, off_scale=3.0, conv={})
    _check_against_plain(args, grad, {})


def test_dx_kernel_order_samples_outside_and_a_zero_mask():
    """Offsets of 20-30 px (every sample outside: dx and d_mask are 0) for
    one image, a zero mask (dx 0, d_offset from the x lerp only) for the
    other; held against the plain backward elementwise."""
    args, grad = _inputs(13, b=2, h=6, w=10, c_in=64, c_out=64, off_scale=1.0, conv={})
    x, off, mask, weight = args
    off[0] = np.sign(off[0]) * (20 + 10 * np.abs(off[0]))
    mask[1] = 0.0
    xt, ot, mt, wt = (torch.from_numpy(a) for a in (x, off, mask, weight))
    got = _dx_kernel_order(xt, ot, mt, wt, torch.from_numpy(grad), {})
    ref = dc.modulated_deform_conv_backward_plain(xt, ot, mt, wt, torch.from_numpy(grad))[:3]
    assert float(got[0][0].abs().max()) == 0 and float(got[2][0].abs().max()) == 0
    assert float(got[0][1].abs().max()) == 0
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * float(r.abs().max()) + 1e-30)


@pytest.mark.parametrize('conv', CONVS, ids=CONV_IDS)
def test_dx_kernel_order_equals_jax_f32(conv, monkeypatch):
    """Against jax.grad of the JAX op in f32 (its pairs formulation)."""
    monkeypatch.setenv('VD3D_DCN_TRAIN_PACKED', '0')
    args, grad = _inputs(14, b=1, h=8, w=12, c_in=24, c_out=16, off_scale=2.5, conv=conv)
    bias = np.zeros(16, np.float32)
    fn = jax.jit(jax.grad(lambda x, o, m: jnp.sum(
        jax_mdc(x, o, m, jnp.asarray(args[3]), jnp.asarray(bias), train=True, **conv)
        * jnp.asarray(grad)), argnums=(0, 1, 2)))
    ref = [np.asarray(r) for r in fn(*map(jnp.asarray, args[:3]))]
    got = _dx_kernel_order(*(torch.from_numpy(a) for a in args), torch.from_numpy(grad), conv)
    for name, g, r in zip(('dx', 'd_offset', 'd_mask'), got, ref):
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize('c_out, taps, want', [
    # 64 pixels, dy resident: ring 4 x 64 x 68 x 4 = 69632, W pieces 2 groups x 2 x
    # 32 x 68 x 4 = 34816, dy 64 x 68 x 4 = 17408, the tables of two tiles
    # 2 x 9 x 64 x 32 = 36864, the sums 9 x 64 x 16 = 9216
    (64, 9, (64, True, 167936)),
    (70, 9, (64, True, 167936 + 32 * 68 * 4)),  # dy rows rounded up to 96
    (256, 9, (64, True, 220160)),  # dy 256 x 68 x 4 = 69632
    # C_out 320: dy 87040 would make 237568 > 232448; in pieces: 2 x 2 x 32 x (68 + 68)
    # x 4 = 69632
    (320, 9, (64, False, 69632 + 69632 + 46080)),
    # 5x5: 64 pixels need 249856 (the tables and sums 25 x 64 x 80 = 128000); 32 pixels
    (64, 25, (32, True, 34816 + 34816 + 64 * 36 * 4 + 25 * 32 * 80)),
    # 7x7: 64 pixels need the tables and sums alone 49 x 64 x 80 = 250880; 32 pixels:
    # ring 4 x 32 x 68 x 4 = 34816, dy 64 x 36 x 4 = 9216, tables and sums 125440
    (64, 49, (32, True, 34816 + 34816 + 9216 + 125440)),
    (512, 127, (None, False, 34816 + 4 * 32 * (68 + 36) * 4 + 127 * 32 * 80)),
])
def test_dx_f32_plan_by_hand(c_out, taps, want):
    assert dc.dx_f32_plan(c_out, taps) == want
    tile, resident, smem = want
    assert smem == dc.dx_f32_smem(tile or 32, taps, c_out, resident)
    assert (smem <= dc.SMEM_LIMIT) == (tile is not None)
    if tile is not None and not resident:  # the plan took the first layout that fits
        assert dc.dx_f32_smem(tile, taps, c_out, True) > dc.SMEM_LIMIT


def _reduce4_over_16_lanes(s):
    """``reduce4_over_16_lanes`` of the source on 32 lanes' s [32, 4]."""
    lanes = np.arange(32)
    shfl = lambda v, m: v[lanes ^ m]  # __shfl_xor_sync
    hi8, hi4 = (lanes & 8) != 0, (lanes & 4) != 0
    k0 = np.where(hi8, s[:, 2], s[:, 0]) + shfl(np.where(hi8, s[:, 0], s[:, 2]), 8)
    k1 = np.where(hi8, s[:, 3], s[:, 1]) + shfl(np.where(hi8, s[:, 1], s[:, 3]), 8)
    v = np.where(hi4, k1, k0) + shfl(np.where(hi4, k0, k1), 4)
    v = v + shfl(v, 2)
    return v + shfl(v, 1)


def test_lane_reduction_of_the_four_sums():
    """Lane l with l % 4 == 0 holds the sum over its 16-lane half of sum q
    = 2 bit3(l) + bit2(l), as the scatter's owner lanes store it."""
    src = SRC.read_text()
    assert 'k0 += __shfl_xor_sync(0xffffffffu, hi8 ? s[0] : s[2], 8);' in src
    assert 'v += __shfl_xor_sync(0xffffffffu, hi4 ? k0 : k1, 4);' in src
    assert 'const int q = ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);' in src
    assert 'if (pl[g] >= 0 && (lane & 3) == 0) {' in src
    s = np.random.default_rng(3).standard_normal((32, 4))
    got = _reduce4_over_16_lanes(s)
    for lane in range(0, 32, 4):
        q = ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1)
        half = slice(lane & 16, (lane & 16) + 16)
        np.testing.assert_allclose(got[lane], s[half, q].sum(), rtol=1e-12)


@pytest.mark.parametrize('o_n, i_n, ld', [(32, 64, 68), (32, 32, 36)])
def test_transposing_copy_lanes(o_n, i_n, ld):
    """``copy_dy_transposed``: every (o, pixel) once; a warp's 32 copies
    write 32 distinct banks (ld = 4 mod 32) and read 4 runs of 8
    consecutive o."""
    src = SRC.read_text()
    assert ('const int o = (blk % (O / 8)) * 8 + (ln & 7), i = (blk / (O / 8)) * 4 + (ln >> 3);'
            in src)
    e = np.arange(o_n * i_n)
    blk, ln = e >> 5, e & 31
    o = (blk % (o_n // 8)) * 8 + (ln & 7)
    i = (blk // (o_n // 8)) * 4 + (ln >> 3)
    assert len(set(zip(o.tolist(), i.tolist()))) == o_n * i_n
    for warp in range(o_n * i_n // 32):
        sl = slice(32 * warp, 32 * warp + 32)
        assert len(set(((o[sl] * ld + i[sl]) % 32).tolist())) == 32
        assert len(set(i[sl].tolist())) == 4


@pytest.mark.parametrize('tile', [64, 32])
def test_fma_tiles_cover_a_stage_once(tile):
    """A group's warp wm owns pixels 32 wm.. of a stage's ds [tile x 64]
    (none at wm = 1 of a 32-pixel tile); lane (mg, ng) the 8 x 8 register
    tile of ``dx_ws_products``: pixels 8 mg.., channels 4 ng.. and 32 + 4
    ng..; together they cover the stage once, and a quarter warp's w loads
    (and ds stores) are one contiguous 128-byte run."""
    src = SRC.read_text()
    assert 'const bool rows = 32 * wm < TP;' in src
    assert 'const float* ap = a + m0 + 8 * (lane >> 3);' in src
    assert 'const float* wp = w + 4 * (lane & 7);' in src
    assert 'nb1 = ld4(wp + on * W_LD + 32);' in src
    assert 'float* ds = slot(it) + (32 * wm + 8 * (lane >> 3)) * C::ds_ld + 4 * (lane & 7);' in src
    seen = np.zeros((tile, dc.DX_F32_CHANNELS), int)
    for wm in (0, 1):
        if 32 * wm >= tile:
            continue
        for lane in range(32):
            mg, ng = lane >> 3, lane & 7
            for i in range(8):
                for h in range(2):
                    seen[32 * wm + 8 * mg + i, 32 * h + 4 * ng:32 * h + 4 * ng + 4] += 1
    assert (seen == 1).all()
    for q in range(4):  # a quarter warp: lanes 8q..8q+7, one mg, ng = 0..7
        starts = [4 * (lane & 7) for lane in range(8 * q, 8 * q + 8)]
        assert starts == list(range(0, 32, 4))  # 8 float4 back to back: 128 bytes


def test_named_barriers_fit():
    """Full and empty per stage, one per FMA group and all FMA warps': at
    most 15 (barrier 0 is __syncthreads); the groups divide the stages."""
    assert 2 * dc.DX_F32_STAGES + dc.DX_F32_FMA_GROUPS + 1 <= 15
    assert dc.DX_F32_STAGES % dc.DX_F32_FMA_GROUPS == 0
    src = SRC.read_text()
    assert 'constexpr int kDxBarFmaAll = kDxBarFma + kDxWsFmaGroups;' in src
    assert 'static_assert(kDxWsStages % kDxWsFmaGroups == 0' in src


def test_dx_f32_constants_match_the_source():
    src = SRC.read_text()
    for name, value in (('kDxWsStages', dc.DX_F32_STAGES), ('kDxWsCh', dc.DX_F32_CHANNELS),
                        ('kDxWsOc', dc.DX_F32_PIECE), ('kDxWsPieces', dc.DX_F32_PIECES),
                        ('kDxWsFmaGroups', dc.DX_F32_FMA_GROUPS), ('kWsMaxSmem', dc.SMEM_LIMIT)):
        assert f'constexpr int {name} = {value};' in src, name


@pytest.mark.parametrize('tile, fma_groups', [(64, 2), (32, 2), (64, 1), (64, 3)])
def test_each_scatter_warp_builds_the_tables_it_reads(tile, fma_groups):
    """A scatter warp builds the corner-table entries of exactly the pixels
    its items read (``build_tables`` against ``dx_ws_scatter``'s items e =
    stid + g ST, pixel e / 16), every tap of them; the warps together build
    every pixel of the tile once."""
    src = SRC.read_text()
    assert 'const int item = wbase + j * C::ST + 16 * half;  // a half warp\'s first item' in src
    assert 'const int e = stid + g * C::ST;' in src
    k_taps, st = 9, 512 - 64 * fma_groups
    items = tile * dc.DX_F32_CHANNELS // 4
    g_n = -(-items // st)
    built = {}
    for wbase in range(0, st, 32):
        for lane in range(32):
            for e in range(lane, g_n * 2 * k_taps, 32):
                j, r = divmod(e, 2 * k_taps)
                half, k = divmod(r, k_taps)
                item = wbase + j * st + 16 * half
                if item < items:
                    built.setdefault(item // 16, []).append((wbase, k))
        read = {(stid + g * st) // 16 for stid in range(wbase, wbase + 32) for g in range(g_n)
                if stid + g * st < items}
        mine = {pl for pl, owners in built.items() if any(w == wbase for w, _ in owners)}
        assert mine == read
    assert sorted(built) == list(range(tile))
    for owners in built.values():
        assert sorted(k for _, k in owners) == list(range(k_taps))
        assert len({w for w, _ in owners}) == 1
