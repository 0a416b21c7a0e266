"""K6's order of work (``premul_lerp_accum_kernel``, ``csrc/deform_conv.cu``),
in torch, on the CPU.

The kernel runs on the card only. Its division of the output is written out
here from :func:`premul_plan`: blocks of 8 x 16 output pixels (a warp a row,
the last tiles ragged) and of output channels (64 a chunk, 8 a lane; 8 a
chunk, one a lane, on the scalar path); each warp's corner entries of its 16
pixels and K taps (-1 and zero weights for a pixel past the map's edge or a
corner outside the image); each lane's 4 pixels (columns 4i + slot) and its
channels, the taps in order, the four corners lerped with each product and
sum rounded on its own, the f32 sum rounded once to bf16, then the bias added
in bf16. It is held bit for bit against ``premul_lerp_accumulate_plain``
(the kernel's own gate on the card), at tile edges, for far offsets, on the
-1 / H edges, with stride and dilation, on the scalar path and with the
generic instance (K = 4 and 25); every output element must be written
exactly once. The plan is checked against the neck's shapes by hand.
"""
import numpy as np
import pytest
import torch

from visualdet3d_tpu_torch.ops import deform_conv as dc

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, b, h, w, c_out, kh, kw, conv, off_std=2.0, far=0.05):
    rng = np.random.default_rng(seed)
    k = kh * kw
    ho, wo = dc.output_hw(h, w, kh, kw, conv.get('stride', 1), conv.get('padding', 1),
                          conv.get('dilation', 1))
    y = torch.from_numpy(rng.standard_normal((b, h, w, k * c_out)).astype(np.float32)).to(BF16)
    off = rng.standard_normal((b, ho, wo, 2 * k)) * off_std
    big = np.sign(off) * (20 + 20 * rng.random(off.shape))
    off = np.where(rng.random(off.shape) < far, big, off)
    offset = torch.from_numpy(off.astype(np.float32)).to(BF16)
    mask = torch.sigmoid(torch.from_numpy(rng.standard_normal((b, ho, wo, k)).astype(np.float32)
                                          * 2)).to(BF16)
    bias = torch.from_numpy((0.1 * rng.standard_normal(c_out)).astype(np.float32)).to(BF16)
    return y, offset, mask, bias


def _k6_order(y, offset, mask, bias, kernel_size, conv):
    """K6's output as its blocks, warps and lanes compute it; NaN where no
    lane writes, and a count of the writes of each element."""
    b, h, w, kc = y.shape
    kh, kw = kernel_size
    k_taps = kh * kw
    c_out = kc // k_taps
    stride, padding, dilation = (conv.get('stride', 1), conv.get('padding', 1),
                                 conv.get('dilation', 1))
    ho, wo = dc.output_hw(h, w, kh, kw, stride, padding, dilation)
    plan = dc.premul_plan(ho, wo, c_out, k_taps, vec=True)
    rows, cols = dc.PREMUL_TILE
    per_lane = plan['channels_per_lane']
    # the corner origins and lerp weights of every (pixel, tap), as corner_entry forms them
    y0, x0, (wx0, wx1, wy0, wy1) = dc._corners(offset, mask, h, w, kh, kw, stride, padding,
                                               dilation, BF16)
    table = y.reshape(b, h * w, k_taps, c_out).float()
    out = torch.full((b, ho, wo, c_out), float('nan'))
    writes = torch.zeros((b, ho, wo, c_out), dtype=torch.int32)
    lane_px = [4 * i + (lane >> 3) for lane in range(32) for i in range(4)]
    assert sorted(set(lane_px)) == list(range(cols))  # 4 pixels a lane cover the row
    for bi in range(b):
        for ty in range(plan['tiles_y']):
            for tx in range(plan['tiles_x']):
                for warp in range(rows):
                    r = ty * rows + warp
                    if r >= ho:
                        continue  # the warp returns
                    px = torch.arange(cols)
                    cols_in = tx * cols + px
                    inside_map = cols_in < wo
                    cl = cols_in.clamp(max=wo - 1)
                    for chunk in range(plan['chunks']):
                        chans = [chunk * 8 * per_lane + j * per_lane + v
                                 for j in range(8) for v in range(per_lane)]
                        chans = torch.tensor([ch for ch in chans if ch < c_out])
                        acc = torch.zeros((cols, len(chans)))
                        for k in range(k_taps):  # the taps in order
                            yy, xx = y0[bi, r, cl, k], x0[bi, r, cl, k]
                            vals = []
                            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                                cy, cx = yy + dy, xx + dx
                                ok = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w) & inside_map
                                idx = torch.where(ok, cy * w + cx, torch.full_like(cy, -1))
                                v = table[bi, idx.clamp(min=0), k][:, chans]
                                vals.append(torch.where((idx >= 0)[:, None], v, 0.0))
                            wts = [t[bi, r, cl, k][:, None] for t in (wx0, wx1, wy0, wy1)]
                            wts = [torch.where(inside_map[:, None], t, 0.0) for t in wts]
                            vx0 = vals[0] * wts[2] + vals[2] * wts[3]
                            vx1 = vals[1] * wts[2] + vals[3] * wts[3]
                            acc = acc + (vx0 * wts[0] + vx1 * wts[1])
                        res = acc.to(BF16)
                        if bias is not None:
                            res = res + bias[chans]
                        for p in range(cols):
                            if inside_map[p]:
                                out[bi, r, cols_in[p], chans] = res[p].float()
                                writes[bi, r, cols_in[p], chans] += 1
    return out, writes


CASES = [  # name, (b, h, w, c_out), kernel, conv, off_std, far
    ('tile_edges', (2, 13, 21, 64), (3, 3), {}, 2.0, 0.05),
    ('far_offsets', (1, 10, 18, 64), (3, 3), {}, 0.0, 1.0),
    ('chunks', (1, 9, 16, 136), (3, 3), {}, 3.0, 0.1),
    ('stride2', (1, 18, 34, 64), (3, 3), dict(stride=2), 2.0, 0.05),
    ('dilation2', (1, 12, 20, 64), (3, 3), dict(padding=2, dilation=2), 2.0, 0.05),
    ('scalar_c5', (2, 7, 9, 5), (3, 3), {}, 3.0, 0.05),
    ('generic_k4', (1, 9, 17, 16), (2, 2), dict(padding=0), 2.0, 0.05),
    ('generic_k25', (1, 8, 18, 8), (5, 5), dict(padding=2), 2.0, 0.05),
]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_kernel_order_equals_plain_bit_for_bit(case):
    _, (b, h, w, c_out), ks, conv, off_std, far = case
    y, offset, mask, bias = _inputs(len(case[0]) + c_out, b, h, w, c_out, *ks, conv, off_std, far)
    out, writes = _k6_order(y, offset, mask, bias, ks, conv)
    assert torch.equal(writes, torch.ones_like(writes)), 'every element written exactly once'
    ref = dc.premul_lerp_accumulate_plain(y, offset, mask, bias, ks, **conv)
    assert torch.equal(out.to(BF16), ref)
    # and the wrapper takes the plain version for CPU tensors
    assert torch.equal(dc.premul_lerp_accumulate(y, offset, mask, bias, ks, **conv), ref)


def test_kernel_order_on_the_edges_of_the_image():
    """Samples exactly on -1, H - 1 and H: the corners outside contribute 0."""
    y, offset, mask, bias = _inputs(7, 1, 6, 7, 64, 3, 3, {}, off_std=0.0, far=0.0)
    off = offset.float()
    off[0, 0, 0, 0::2] = torch.tensor([0, 0, 0, -1, 0, 0, 6, 5, 4.0])
    off[0, 3, 3, 1::2] = torch.tensor([-3, 3.5, 2, -1, 0, 0, 0.5, 0, 0])
    off = off.to(BF16)
    out, writes = _k6_order(y, off, mask, None, (3, 3), {})
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(out.to(BF16), dc.premul_lerp_accumulate_plain(y, off, mask, None))


def test_plan_at_the_neck_shapes():
    """The 8 proj DCNs of the KM3D neck at 384x1280 (C_out < C_in), by hand."""
    big = dc.premul_plan(48, 160, 64)
    assert (big['tiles_y'], big['tiles_x'], big['chunks'], big['channels_per_lane']) == (6, 10, 1, 8)
    assert big['taps'] == 9 and big['smem'] == 8 * 9 * 8 * 16 * 4 == 36864  # under 48 KB
    top = dc.premul_plan(12, 40, 256)
    assert (top['tiles_y'], top['tiles_x'], top['chunks']) == (2, 3, 4)
    mid = dc.premul_plan(24, 80, 128)
    assert (mid['tiles_y'], mid['tiles_x'], mid['chunks']) == (3, 5, 2)
    assert dc.premul_plan(24, 80, 64)['chunks'] == 1


def test_plan_scalar_and_generic_instances():
    scalar = dc.premul_plan(7, 9, 5)
    assert (scalar['channels_per_lane'], scalar['chunks']) == (1, 1)
    assert dc.premul_plan(7, 9, 64, vec=False)['chunks'] == 8  # an unaligned table
    k4 = dc.premul_plan(9, 17, 16, taps=4)
    assert k4['taps'] == 0 and k4['smem'] == 16384
    k25 = dc.premul_plan(8, 18, 8, taps=25)
    assert k25['taps'] == 0 and k25['smem'] == 102400  # past 48 KB: the opt-in
    assert dc.premul_plan(8, 8, 8, taps=dc.PREMUL_MAX_TAPS)['smem'] <= 232448


def test_kernel_source_keeps_the_plan():
    from visualdet3d_tpu_torch.ops import kernel_build
    src = (kernel_build.CSRC_DIR / 'deform_conv.cu').read_text()
    rows, cols = dc.PREMUL_TILE
    assert cols == 4 * 4  # 4 lanes' slots x kPremulPix pixels
    for text in (f'constexpr int kPremulRows = {rows};', 'constexpr int kPremulPix = 4;',
                 'constexpr int kPremulCols = 4 * kPremulPix;',
                 f'constexpr int kPremulTaps = {dc.PREMUL_TAPS};',
                 f'constexpr int kPremulMaxTaps = {dc.PREMUL_MAX_TAPS};',
                 '(k * kPremulCols + 4 * i + slot) * 8', '*reinterpret_cast<int4*>(tab + e * 8) = offs;'):
        assert text in src, text
