"""The arithmetic of the warp-specialised DCN kernels, in torch, on the CPU.

The per-tap forward (K3/K5) and the dW pass of the backward (K7) run on the
card only. Their order of work is written out here in torch and held
against the plain versions (and the forward against the JAX package's K5,
the Pallas kernel in interpret mode): the forward's tiles of output pixels
of one image and of output channels, its taps and C_in chunks in the order
the kernel accumulates them; dW's row blocks (taps x input channels), its
splits of the batch's pixels into runs of stages, the per-split partial
sums and their reduce in split order. The plan functions that size these
(``consumer_warps``, ``dw_tile``, ``dw_rows``, ``dw_stages``, ``dw_plan``)
are checked against cases worked out by hand, and the text that
``dcn_study.py`` patches in the kernel source against that source (the f32
dx kernel's order: ``tests/test_torch_dcn_dx.py``).

Tolerances, f32: the forward within 3e-5 of JAX (the convention of
``tests/test_torch_deform_conv.py``: the frameworks sum the K * C_in tap
products in other orders) and within 1e-5 of max|out| of the plain version;
dW within 1e-5 of max|dW| of autograd through the plain forward (the same
products summed in another order).
"""
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualdet3d_tpu.ops.deform_conv import _packed_f32_ok, modulated_deform_conv as jax_mdc
from visualdet3d_tpu_torch.ops import deform_conv as dc

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
    bias = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    grad = rng.standard_normal((b, ho, wo, c_out)).astype(np.float32)
    return (x, offset, mask, weight, bias), grad


def _sampled(x, offset, mask, kh, kw, conv):
    """Every tap's bilinear samples [B, Ho*Wo, C_in], rounded as the
    kernels round them (to x's dtype), in f32."""
    b, h, w, c_in = x.shape
    stride, padding, dilation = (conv.get('stride', 1), conv.get('padding', 1),
                                 conv.get('dilation', 1))
    y0, x0, weights = dc._corners(offset, mask, h, w, kh, kw, stride, padding, dilation,
                                  x.dtype)
    flat = x.reshape(b, h * w, c_in).float()
    return [dc._sample_tap(flat, y0, x0, weights, k, h, w).to(x.dtype).float()
            for k in range(kh * kw)]


def _forward_kernel_order(x, offset, mask, weight, bias, conv):
    """The per-tap forward kernel's work in torch, f32: tiles of P output
    pixels of one image x 64 NT output channels (NT and P as the kernel
    picks them from C_out), per tile the taps in order and each tap's C_in
    in chunks of 32 channels (the f32 stage), one product added at a time
    into the tile's f32 accumulators; then the output rounded to x's dtype
    and the bias added."""
    b, h, w, c_in = x.shape
    kh, kw, _, c_out = weight.shape
    ho, wo = offset.shape[1:3]
    nt = 1 if c_out <= 64 else 2 if c_out <= 128 else 4
    tile_p, tile_n, chunk = 32 * dc.consumer_warps(nt) // nt, 64 * nt, 32
    sampled = _sampled(x, offset, mask, kh, kw, conv)
    wk = weight.reshape(kh * kw, c_in, c_out).float()
    n_pix = ho * wo
    out = torch.full((b, n_pix, c_out), float('nan'))
    for bi in range(b):
        for p0 in range(0, n_pix, tile_p):
            ps = slice(p0, min(n_pix, p0 + tile_p))
            for o0 in range(0, c_out, tile_n):
                os_ = slice(o0, min(c_out, o0 + tile_n))
                acc = torch.zeros(ps.stop - ps.start, os_.stop - os_.start)
                for k in range(kh * kw):
                    for c0 in range(0, c_in, chunk):
                        for c in range(c0, min(c_in, c0 + chunk)):
                            acc += sampled[k][bi, ps, c, None] * wk[k, c, None, os_]
                out[bi, ps, os_] = acc
    return out.to(x.dtype).reshape(b, ho, wo, c_out) + bias.to(x.dtype)


@pytest.mark.parametrize('conv', CONVS, ids=CONV_IDS)
def test_forward_kernel_order_equals_plain_and_jax_k5(conv):
    """Two pixel tiles an image, the second ragged (9 x 16 = 144 output
    pixels at stride 1, tiles of 128), two C_in chunks of 32."""
    args, _ = _inputs(7, b=2, h=9, w=16, c_in=64, c_out=48, off_scale=3.0, conv=conv)
    x, off, mask, weight, bias = (torch.from_numpy(a) for a in args)
    ho, wo = off.shape[1:3]
    out = _forward_kernel_order(x, off, mask, weight, bias, conv)
    plain = dc.modulated_deform_conv_plain(x, off, mask, weight, bias, **conv)
    assert out.shape == plain.shape and not torch.isnan(out).any()
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5 * float(plain.abs().max()))
    assert _packed_f32_ok(ho * wo, 64, 48, jnp.float32), 'the JAX op must take K5 here'
    ref = np.asarray(jax.jit(lambda *a: jax_mdc(*a, **conv))(*map(jnp.asarray, args)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=3e-5)


def _dw_kernel_order(x, offset, mask, grad, conv, n_sm):
    """The dW kernel's work in torch, f32: the batch's output pixels in
    stages of ``DW_STAGE_PIXELS`` pixels of one image, the stages split as
    ``dw_plan`` splits them for ``n_sm`` SMs; per split and block of rows
    (``dw_rows``: taps x input channels) and columns (``dw_tile``), the
    stage products sampled^T . dy summed stage by stage into f32 partial
    sums, each written once into the split's slice of the partials; then
    the splits added in split order. Returns (dW, splits)."""
    b, h, w, c_in = x.shape
    kh = kw = 3
    k_taps = kh * kw
    c_out = grad.shape[-1]
    n_pix = grad.shape[1] * grad.shape[2]
    pk = dc.DW_STAGE_PIXELS[x.dtype]
    sampled = _sampled(x, offset, mask, kh, kw, conv)
    dy = grad.reshape(b, n_pix, c_out).float()
    stages = [(bi, p0) for bi in range(b) for p0 in range(0, n_pix, pk)]
    assert len(stages) == dc.dw_stages(b, grad.shape[1], grad.shape[2], x.dtype)
    splits = dc.dw_plan(len(stages), c_in, c_out, k_taps, n_sm)
    per = -(-len(stages) // splits)
    assert -(-len(stages) // per) == splits  # no split is empty
    tpb, ci, n_kb, n_ccb = dc.dw_rows(c_in, c_out, k_taps)
    tile_n = dc.dw_tile(c_out)[1]
    part = torch.full((splits, k_taps, c_in, c_out), float('nan'))
    for s in range(splits):
        written = torch.zeros(k_taps, c_in, c_out, dtype=torch.int64)
        for kb in range(n_kb):
            taps = range(kb * tpb, min(k_taps, (kb + 1) * tpb))
            for cb in range(n_ccb):
                cs = slice(cb * ci, min(c_in, (cb + 1) * ci))
                for o0 in range(0, c_out, tile_n):
                    os_ = slice(o0, min(c_out, o0 + tile_n))
                    acc = torch.zeros(len(taps), cs.stop - cs.start, os_.stop - os_.start)
                    for bi, p0 in stages[s * per:(s + 1) * per]:
                        ps = slice(p0, min(n_pix, p0 + pk))
                        for kk, k in enumerate(taps):
                            acc[kk] += sampled[k][bi, ps, cs].T @ dy[bi, ps, os_]
                    part[s, taps.start:taps.stop, cs, os_] = acc
                    written[taps.start:taps.stop, cs, os_] += 1
        assert bool((written == 1).all()), 'the blocks must cover dW exactly once'
    dw = part[0]
    for s in range(1, splits):
        dw = dw + part[s]
    return dw.reshape(kh, kw, c_in, c_out), splits


@pytest.mark.parametrize('conv', CONVS, ids=CONV_IDS)
def test_dw_kernel_order_equals_autograd(conv):
    """63 output pixels an image at stride 1: two stages of 32 each, the
    second ragged; 4 SMs make the plan split the 4 stages 4 ways."""
    args, grad = _inputs(8, b=2, h=7, w=9, c_in=5, c_out=6, off_scale=3.0, conv=conv)
    x, off, mask, weight, _ = (torch.from_numpy(a) for a in args)
    grad = torch.from_numpy(grad)
    dw, splits = _dw_kernel_order(x, off, mask, grad, conv, n_sm=4)
    assert splits > 1
    ref = dc.modulated_deform_conv_backward_plain(x, off, mask, weight, grad, **conv)[3]
    assert dw.shape == ref.shape and not torch.isnan(dw).any()
    torch.testing.assert_close(dw, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_dw_kernel_order_row_blocks_and_column_tiles():
    """C_in 40 x C_out 70 at 2 SMs: column tiles of 128, rows of 128 =
    3 taps x 40 channels a block (3 blocks along the taps), several
    splits."""
    args, grad = _inputs(9, b=1, h=6, w=11, c_in=40, c_out=70, off_scale=2.0, conv={})
    x, off, mask, weight, _ = (torch.from_numpy(a) for a in args)
    grad = torch.from_numpy(grad)
    assert dc.dw_rows(40, 70) == (3, 40, 3, 1)
    dw, _ = _dw_kernel_order(x, off, mask, grad, {}, n_sm=2)
    ref = dc.modulated_deform_conv_backward_plain(x, off, mask, weight, grad)[3]
    torch.testing.assert_close(dw, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_tiles_by_hand():
    """consumer warps: 4 at 64 output channels, else 8; a 32 x 64 tile
    each, so dW's block is (32 warps / NT) rows x 64 NT columns."""
    assert [dc.consumer_warps(nt) for nt in (1, 2, 4)] == [4, 8, 8]
    assert dc.dw_tile(64) == (128, 64) and dc.dw_tile(5) == (128, 64)
    assert dc.dw_tile(128) == (128, 128) and dc.dw_tile(70) == (128, 128)
    assert dc.dw_tile(256) == (64, 256) and dc.dw_tile(300) == (64, 256)


@pytest.mark.parametrize('c_in, c_out, want', [
    (64, 64, (2, 64, 5, 1)),     # 128 rows: 2 taps of 64, 9 taps -> 5 blocks of 2, 2, 2, 2, 1
    (128, 64, (1, 128, 9, 1)),   # a tap of 128 channels a block
    (256, 64, (1, 128, 9, 2)),   # C_in in two blocks of 128
    (256, 256, (1, 64, 9, 4)),   # 64 rows: C_in in four blocks
    (512, 256, (1, 64, 9, 8)),
    (5, 6, (9, 5, 1, 1)),        # every tap in one block of 45 rows
    (33, 70, (3, 33, 3, 1)),     # 128 rows hold 3 taps of 33
])
def test_dw_rows_by_hand(c_in, c_out, want):
    assert dc.dw_rows(c_in, c_out) == want
    tpb, ci, n_kb, n_ccb = want
    assert tpb * ci <= dc.dw_tile(c_out)[0] and n_kb * tpb >= 9 > (n_kb - 1) * tpb
    assert n_ccb * ci >= c_in > (n_ccb - 1) * ci


@pytest.mark.parametrize('c_in, c_out, want', [
    (64, 64, 5),      # 5 tap blocks x 1 C_in block x 1 column tile
    (256, 128, 18),   # 9 x 2 x 1
    (512, 256, 72),   # 9 x 8 x 1: 256 columns in one tile
    (33, 300, 18),    # dw_rows(33, 300) = (1, 33, 9, 1); 300 columns in two tiles of 256
])
def test_dw_tiles_by_hand(c_in, c_out, want):
    assert dc.dw_tiles(c_in, c_out) == want


def test_dw_stages_by_hand():
    # 96 x 320 = 30720 pixels an image: 480 stages of 64 (bf16), 960 of 32 (f32)
    assert dc.dw_stages(16, 96, 320, torch.bfloat16) == 16 * 480
    assert dc.dw_stages(16, 96, 320, torch.float32) == 16 * 960
    # 7 x 9 = 63 pixels: one ragged stage of 64, two of 32
    assert dc.dw_stages(2, 7, 9, torch.bfloat16) == 2
    assert dc.dw_stages(2, 7, 9, torch.float32) == 4


@pytest.mark.parametrize('chunks, c_in, c_out, n_sm, want', [
    # 5 row blocks (dw_rows(64, 64)) on 132 SMs: one wave of 26 splits, 296
    # stages each: 1 x (296 + 3) = 299, against 2 waves of 52 (2 x 151 =
    # 302) and 3 of 79 (3 x 101 = 303)
    (7680, 64, 64, 132, 26),
    # 36 blocks (256 -> 256): 3 splits fill 108 SMs: 1 x (160 + 3) = 163;
    # 7 splits, 2 waves: 2 x (69 + 3) = 144; 11, 3 waves: 3 x (44 + 3) =
    # 141; 14, 4 waves: 4 x (35 + 3) = 152; 18, 5: 5 x (27 + 3) = 150;
    # 22, 6: 6 x (22 + 3) = 150; 25, 7 (ceil(480 / 25) = 20 stages, 24
    # splits): 7 x 23 = 161; 29, 8 (17 stages, 29 splits): 8 x 20 = 160
    (480, 256, 256, 132, 11),
    # one block, 4 stages, 4 SMs: 4 splits of one stage, 1 x (1 + 3)
    (4, 5, 6, 4, 4),
])
def test_dw_plan_by_hand(chunks, c_in, c_out, n_sm, want):
    got = dc.dw_plan(chunks, c_in, c_out, 9, n_sm)
    assert got == want
    per = math.ceil(chunks / got)
    assert math.ceil(chunks / per) == got  # every split non-empty


def test_backward_launch_keys():
    """The backward counts three kernels: dx, dW's split sums, their reduce."""
    assert {k for k in dc.LAUNCHES if k.startswith('modulated_deform_conv_backward')} == {
        'modulated_deform_conv_backward_input', 'modulated_deform_conv_backward_weight',
        'modulated_deform_conv_backward_weight_reduce'}


def _study():
    spec = importlib.util.spec_from_file_location(
        'dcn_study', pathlib.Path(__file__).resolve().parent.parent / 'dcn_study.py')
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    return study


@pytest.mark.parametrize('variant', ['no_mma', 'l1_hit', 'producers_copy', 'consumers_copy',
                                     'one_group', 'laps', 'dx_no_ds', 'dx_no_atomics',
                                     'dx_no_ds_no_atomics', 'dx_no_scatter', 'dx_no_copy',
                                     'dx_no_scatter_no_copy', 'dx_fma_groups_1',
                                     'dx_fma_groups_3', 'dx_fma_groups_4', 'dx_tile_32',
                                     'dx_stages_2',
                                     'dx_tile_w_64', 'dx_tile_w_32', 'dx_tile_w_16',
                                     'dx_tile_w_8', 'dx_laps'])
def test_study_patches_match_the_source(variant):
    """Each of ``dcn_study.py``'s substitutions finds its text in
    ``csrc/deform_conv.cu`` (a variant changes every copy; a lap lands in
    one place), so the study builds what it says. The forward's anchors
    hold in the ring body that K3/K5 and K4 share."""
    study = _study()
    laps = {'laps': study.LAP_SUBS, 'dx_laps': study.DX_LAP_SUBS}
    subs = laps.get(variant) or study.VARIANTS[variant]
    text = study.SRC.read_text()
    assert subs
    for old, _ in subs:
        assert text.count(old) == 1 if variant in laps else old in text, old[:80]
    assert study.substitute(text, subs) != text


def test_study_lists_every_variant():
    """The parametrisation above covers every variant the study builds."""
    study = _study()
    assert set(study.VARIANTS) - {'as_is'} == {
        'no_mma', 'l1_hit', 'producers_copy', 'consumers_copy', 'one_group', 'dx_no_ds',
        'dx_no_atomics', 'dx_no_ds_no_atomics', 'dx_no_scatter', 'dx_no_copy',
        'dx_no_scatter_no_copy', 'dx_fma_groups_1', 'dx_fma_groups_3', 'dx_fma_groups_4',
        'dx_tile_32', 'dx_stages_2', 'dx_tile_w_64', 'dx_tile_w_32', 'dx_tile_w_16',
        'dx_tile_w_8'}


def test_alltaps_kernel_runs_the_ring():
    """K4's kernel is the per-tap kernel's ring under its own symbol: both
    call ``fwd_ring``, and the serial all-taps body (WMMA fragments) is gone."""
    text = _study().SRC.read_text()
    assert text.count('fwd_ring<') == 2
    body = text[text.index('deform_conv_alltaps_kernel(const'):]
    body = body[:body.index('\n}\n')]
    assert 'fwd_ring<__nv_bfloat16, NT>(' in body and 'wmma' not in body
