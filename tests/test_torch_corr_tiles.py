"""The correlation kernel's order of work (K1/K2, ``csrc/correlation.cu``), in
torch, on the CPU.

The kernel runs on the card only. Its division of the volume is written out
here in torch from :func:`correlation_plan` and held against the plain
version and the JAX package's ``correlation_volume_xla``: items of (pair,
row, 64-column tile, chunk of disparities), each staging its left tile and
its right tile with the chunk's halo (zero outside the image and past C) in
128-byte channel chunks; in bf16 each warp's 16 columns against the ``8 *
nt`` right columns its band touches, the band kept; in f32 each lane's 4 x 4
block on the k-th diagonal. Every output entry must be written exactly once.
The interleaved and the separate-eye layouts go through the same element
offsets the launcher passes (base pointers and the pair stride).

Tolerances: f32 1e-5 (the sums run in another order); bf16 one bf16 ulp of
the f32 value + 1e-5 (bf16 products are exact in f32; only the output's
rounding and the sum order differ), the gates of ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualdet3d_tpu.ops.cost_volume import correlation_volume_xla
from visualdet3d_tpu_torch.ops import cost_volume as cv


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _swz(r: int) -> int:
    return (r ^ (r >> 2)) & 7


def _stage_rows(flat, base, pair_stride, b, h, w_start, n_rows, w, c, c0, c_chunk):
    """Rows w_start .. w_start + n_rows of eye row (b, h), channels c0 ..
    c0 + c_chunk, read through element offsets as the kernel reads them;
    columns outside [0, W) and channels past C are zero."""
    rows = torch.zeros((n_rows, c_chunk), dtype=flat.dtype)
    row = base + b * pair_stride + h * w * c
    for r in range(n_rows):
        col = w_start + r
        if 0 <= col < w:
            n = min(c_chunk, c - c0)
            if n > 0:
                rows[r, :n] = flat[row + col * c + c0: row + col * c + c0 + n]
    return rows


def _kernel_order(flat, left_base, right_base, pair_stride, b, h, w, c, num_disp, dtype):
    """The volume [B, H, W, D] as the kernel computes it, NaN where no lane
    writes; a second tensor counts the writes of each entry."""
    plan = cv.correlation_plan(w, c, num_disp, dtype)
    out = torch.full((b, h, w, num_disp), float('nan'))
    writes = torch.zeros((b, h, w, num_disp), dtype=torch.int32)
    scale = 1.0 / c
    tw = cv.CORR_TILE_W
    for bi in range(b):
        for hi in range(h):
            for w0, _ in plan['tiles']:
                for d0, dc, halo in plan['d_chunks']:
                    stages = []
                    for cc in range(plan['n_cc']):
                        c0 = cc * plan['c_chunk']
                        lt = _stage_rows(flat, left_base, pair_stride, bi, hi, w0, tw, w, c, c0,
                                         plan['c_chunk'])
                        rt = _stage_rows(flat, right_base, pair_stride, bi, hi,
                                         w0 - d0 - halo, tw + halo, w, c, c0, plan['c_chunk'])
                        stages.append((lt.float(), rt.float()))
                    for warp in range(4):
                        wc = w0 + 16 * warp
                        if wc >= w:
                            continue  # a warp past the image's edge idles
                        band = {}
                        if dtype == torch.float32:
                            nk = -(-(dc - 1) // 4) + 1
                            for g4 in range(4):
                                for k in range(nk):
                                    lrow = 16 * warp + 4 * g4
                                    rrow = lrow - 4 * k + halo
                                    assert 0 <= rrow and rrow + 3 < tw + halo
                                    acc = torch.zeros((4, 4))
                                    for lt, rt in stages:  # channel chunks in order
                                        acc = acc + lt[lrow:lrow + 4] @ rt[rrow:rrow + 4].T
                                    for i in range(4):
                                        for j in range(4):
                                            d = 4 * k + i - j
                                            if 0 <= d < dc:
                                                assert (4 * g4 + i, d) not in band
                                                band[(4 * g4 + i, d)] = acc[i, j] * scale
                        else:
                            nt = -(-(dc + 15) // 8)
                            assert 8 * nt - 16 == halo
                            acc = torch.zeros((16, 8 * nt))
                            for lt, rt in stages:
                                a = lt[16 * warp:16 * warp + 16]
                                bm = rt[16 * warp:16 * warp + 8 * nt]
                                acc = acc + a @ bm.T
                            for rw in range(16):
                                for col in range(8 * nt):
                                    d = rw + halo - col
                                    if 0 <= d < dc:
                                        band[(rw, d)] = acc[rw, col] * scale
                        assert len(band) == 16 * dc  # the band is whole
                        for (rw, d), v in band.items():
                            if wc + rw < w:
                                out[bi, hi, wc + rw, d0 + d] = v
                                writes[bi, hi, wc + rw, d0 + d] += 1
    return out, writes


def _check(out, writes, ref, dtype):
    assert torch.equal(writes, torch.ones_like(writes)), 'every entry written exactly once'
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-5
    else:
        out16 = out.to(torch.bfloat16).float()
        mag = ref.abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((out16 - ref).abs() <= ulp + 1e-5).all())


CASES = [  # (pairs, H, W, C, D)
    (1, 2, 150, 16, 24),   # three tiles (64, 64, 22): the halo of a split row
    (2, 1, 45, 24, 12),    # W not a multiple of 16, D not a multiple of 8
    (1, 2, 5, 8, 12),      # d >= W: whole columns of zeros
    (1, 1, 70, 136, 30),   # two disparity chunks of 15; C over two or more stages
    (1, 1, 40, 12, 8),     # C not a multiple of a 16-byte piece (no 16-byte copies)
]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', CASES, ids=['split_row', 'ragged', 'd_over_w', 'two_chunks',
                                             'c12'])
@pytest.mark.parametrize('layout', ['interleaved', 'separate'])
def test_kernel_order_matches_plain_and_jax(case, dtype, layout):
    pairs, h, w, c, d = case
    rng = np.random.default_rng(sum(case) + (dtype == torch.float32))
    both = rng.standard_normal((2 * pairs, h, w, c)).astype(np.float32)
    both_t = torch.from_numpy(both).to(dtype)
    left, right = both_t[0::2].contiguous(), both_t[1::2].contiguous()
    eye = h * w * c
    if layout == 'interleaved':
        flat = both_t.reshape(-1)
        out, writes = _kernel_order(flat, 0, eye, 2 * eye, pairs, h, w, c, d, dtype)
    else:
        flat = torch.cat([left.reshape(-1), right.reshape(-1)])
        out, writes = _kernel_order(flat, 0, pairs * eye, eye, pairs, h, w, c, d, dtype)
    ref = cv.correlation_volume_plain(left.float(), right.float(), d)
    _check(out, writes, ref, dtype)
    ref_jax = np.asarray(correlation_volume_xla(jnp.asarray(left.float().numpy()),
                                                jnp.asarray(right.float().numpy()), d))
    assert float(np.abs(ref.numpy() - ref_jax).max()) <= 1e-5
    _check(out, writes, torch.from_numpy(np.array(ref_jax)), dtype)
    if d > w:
        assert torch.all(out[..., w:] == 0)


def test_plan_at_the_stereo_shapes():
    """The two main-path calls of a Stereo3D predict, by hand."""
    s4 = cv.correlation_plan(320, 64, 24, torch.bfloat16)
    assert s4['tiles'] == [(0, 64), (64, 64), (128, 64), (192, 64), (256, 64)]
    assert s4['d_chunks'] == [(0, 24, 24)]  # 5 n8 tiles: 40 columns, halo 24
    assert (s4['c_chunk'], s4['n_cc'], s4['vec']) == (64, 1, True)
    s8 = cv.correlation_plan(160, 128, 24, torch.float32)
    assert s8['tiles'] == [(0, 64), (64, 64), (128, 32)]
    assert s8['d_chunks'] == [(0, 24, 24)]  # 7 diagonal blocks: halo 4 * 6
    assert (s8['c_chunk'], s8['n_cc']) == (32, 4)
    assert cv.correlation_plan(160, 128, 24, torch.bfloat16)['n_cc'] == 2
    # 2 stages of (64 + 96) rows x 128 bytes and 4 warps' bands of 16 x 28
    # floats: 48,128 bytes, four blocks an SM within the H100's 228 KB
    assert s4['smem'] == 2 * 160 * 128 + 4 * 16 * 28 * 4 == 48128


@pytest.mark.parametrize('num_disp,chunks', [(1, [(0, 1)]), (28, [(0, 28)]),
                                             (29, [(0, 15), (15, 14)]),
                                             (57, [(0, 19), (19, 19), (38, 19)]),
                                             (100, [(0, 25), (25, 25), (50, 25), (75, 25)])])
def test_plan_disparity_chunks(num_disp, chunks):
    """Balanced chunks of at most 28 disparities, none empty."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = cv.correlation_plan(64, 64, num_disp, dtype)
        assert [(d0, dc) for d0, dc, _ in plan['d_chunks']] == chunks
        assert all(halo == cv.correlation_halo(dc, dtype) for _, dc, halo in plan['d_chunks'])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_halo_covers_every_band_entry_once_within_the_staged_rows(dtype):
    """For every chunk size up to 28: each (column, disparity) of a warp's 16
    columns is one lane's entry exactly once, and every right row read lies
    in the 64 + halo staged rows (at most the 96 the kernel allots)."""
    for dc in range(1, cv.CORR_MAX_DISP + 1):
        halo = cv.correlation_halo(dc, dtype)
        assert halo <= 32
        seen = {}
        if dtype == torch.float32:
            nk = -(-(dc - 1) // 4) + 1
            assert nk <= 8  # a lane's k is lane % 8
            for warp in range(4):
                for g4 in range(4):
                    for k in range(nk):
                        rrow = 16 * warp + 4 * g4 - 4 * k + halo
                        assert 0 <= rrow and rrow + 3 < 64 + halo
                        for i in range(4):
                            for j in range(4):
                                d = 4 * k + i - j
                                if 0 <= d < dc:
                                    key = (16 * warp + 4 * g4 + i, d)
                                    seen[key] = seen.get(key, 0) + 1
        else:
            nt = -(-(dc + 15) // 8)
            assert nt <= 6
            for warp in range(4):
                assert 16 * warp + 8 * nt <= 64 + halo
                for rw in range(16):
                    for col in range(8 * nt):
                        d = rw + halo - col
                        if 0 <= d < dc:
                            key = (16 * warp + rw, d)
                            seen[key] = seen.get(key, 0) + 1
        assert sorted(seen) == [(w, d) for w in range(64) for d in range(dc)]
        assert set(seen.values()) == {1}


def test_swizzle_spreads_the_reads_over_the_banks():
    """ldmatrix reads 8 consecutive stage rows from a multiple of 8, the f32
    lanes of a quarter warp 8 rows 4 apart: both land in 8 distinct 16-byte
    bank groups under the kernel's swizzle."""
    for r0 in range(0, 96, 8):
        assert len({_swz(r0 + i) for i in range(8)}) == 8
    for start in range(96):
        assert len({_swz(start + 4 * m) for m in range(8)}) == 8


def test_kernel_source_keeps_the_plan():
    """The constants the plan mirrors, in ``csrc/correlation.cu``."""
    from visualdet3d_tpu_torch.ops import kernel_build
    src = (kernel_build.CSRC_DIR / 'correlation.cu').read_text()
    for text in (f'constexpr int kTileW = {cv.CORR_TILE_W};',
                 f'constexpr int kMaxDc = {cv.CORR_MAX_DISP};',
                 f'constexpr int kRowBytes = {cv.CORR_ROW_BYTES};',
                 f'constexpr int kStages = {cv.CORR_STAGES};',
                 'return (r ^ (r >> 2)) & 7;',
                 'return 4 * ((dc - 1 + 3) / 4);',
                 'return 8 * ((dc + 15 + 7) / 8) - 16;'):
        assert text in src, text
