"""The fused int8 block kernel's (K8's) order of work and the activation
quantize's split, written out in torch, on the CPU.

The CUDA kernels cannot run here. What each does in its own order is plain
arithmetic, which these tests transcribe and hold bit for bit against the
plain versions and the JAX package:

* K8 (``csrc/int8_block.cu``): output tiles of ``block_plan``; the staged
  input (2-pixel halo, zero outside the image) and conv1's output hq in one
  flat layout of row pitch P, so that tap (ky, kx) of flat position q is
  staged position q + ky*P + kx; conv1 over the flat region in 64-position
  units (positions past the region's width or last row computed, then
  zeroed), hq zero outside the image; conv2 one 64-pixel row a unit; the
  epilogue with the dequantized residual read from the staged tile. The
  staged positions the TMA box leaves unwritten hold garbage here, as
  shared memory does. Bit for bit against ``int8_basic_block_plain``, and,
  with the two affines' multiply and add rounded once (as XLA's CPU code
  fuses them), against the JAX package's Pallas kernel
  ``int8_basic_block_fused`` in interpret mode; at ragged shapes and at
  layer1's 72 x 320.
* ``block_plan`` by hand: every output pixel in exactly one tile, shared
  memory within the 227 KB a block may have, the grid within the SMs; its
  constants are the CUDA source's.
* The quantize (``csrc/int8_conv.cu``): ``quantize_plan``'s head, 16-element
  vectors, tail and per-thread channel phase at ``n_inv`` 1, 64, 72 and
  1408, sizes off the vector, a base one element past 16-byte alignment, f32
  and bf16, against ``quantize_act_plain`` and JAX's ``_quantize_act``: round
  ties after the multiply, saturation, -0.0.
"""
import importlib.util
import math
import pathlib
import re
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualdet3d_tpu.models import quant as jax_quant
from visualdet3d_tpu.ops.int8_block import int8_basic_block_fused
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.ops import int8_block as ib
from visualdet3d_tpu_torch.ops import int8_conv as ic
from visualdet3d_tpu_torch.ops import kernel_build

C = ib.CHANNELS


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while this module runs (the tier-1 run
    puts six workers on one machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# K8


def k8_by_tiles(xq, w1, w2, params, out_dtype, plan, seed=0, fma=False):
    """K8's order of work in torch: tile by tile, the flat layout of pitch
    P, conv1 in 64-position units with hq's zeroing, conv2 one row a unit,
    the epilogue; s32 sums as float64 products of the integers (exact).
    With ``fma`` the two affines ``acc * scale + shift`` are rounded once
    (a fused multiply-add), as XLA's CPU code for the JAX kernel rounds
    them; the CUDA kernel and the plain version round each operation."""

    def affine(acc, scale, shift):
        if fma:  # the product is exact in float64, the sum rounded once to f32
            return (acc * scale.double() + shift.double()).float()
        return acc.float() * scale + shift

    b, h, w, _ = xq.shape
    p = params
    pitch, th, tw = plan.pitch, plan.tile_h, plan.tile_w
    xr = th + 4
    w1t = w1.reshape(C, 9, C).permute(1, 2, 0).double()  # [tap, c_in, c_out]
    w2t = w2.reshape(C, 9, C).permute(1, 2, 0).double()
    offsets = [(t // 3) * pitch + t % 3 for t in range(9)]
    gen = torch.Generator().manual_seed(seed)
    out = torch.full((b, h, w, C), float('nan')).to(out_dtype)
    ys_in, xs_in = torch.arange(xr), torch.arange(pitch)
    for tile in range(plan.tiles):
        bi, r = divmod(tile, plan.tiles_y * plan.tiles_x)
        y0, x0 = (r // plan.tiles_x) * th, (r % plan.tiles_x) * tw
        # the staged tile: xr rows x pitch pixels from (y0 - 2, x0 - 2), zero
        # outside the image; the positions past xr * pitch are not written
        stage = torch.randint(-128, 128, (plan.x_positions, C), generator=gen, dtype=torch.int8)
        ys, xs = ys_in + y0 - 2, xs_in + x0 - 2
        ok = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None]
        img = xq[bi][ys.clamp(0, h - 1)][:, xs.clamp(0, w - 1)]
        stage[:xr * pitch] = torch.where(ok[..., None], img, 0).reshape(-1, C)
        st = stage.double()
        # conv1 over the flat region in units of 64 positions
        q = torch.arange(64 * plan.units1)
        acc1 = sum(st[q + off] @ w1t[t] for t, off in enumerate(offsets))
        rr, cc = q // pitch, q % pitch
        yy, xx = y0 - 1 + rr, x0 - 1 + cc
        inside = (rr < th + 2) & (cc < tw + 2) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        hf = torch.clamp_min(affine(acc1, p[0], p[1]), 0.0) * p[2]
        hq = torch.where(inside[:, None], torch.clamp(torch.round(hf), -127, 127), 0.0)
        assert hq.shape[0] == plan.h_positions
        hq = hq.double()
        # conv2: output row oy is one unit of 64 pixels
        px = torch.arange(64)
        for oy in range(th):
            y = y0 + oy
            if y >= h:
                continue
            acc2 = sum(hq[oy * pitch + off + px] @ w2t[t] for t, off in enumerate(offsets))
            res = st[(oy + 2) * pitch + px + 2].float()
            v = torch.clamp_min(affine(acc2, p[3], p[4]) + res * p[5], 0.0).to(out_dtype)
            n = min(tw, w - x0)
            out[bi, y, x0:x0 + n] = v[:n]
    return out


def _block(rng, p2=9.0):
    """Random weights and the block's parameters as the JAX package's block
    entry and as the port's [6, 64] rows (formed by ``block_params``)."""
    kq = [rng.integers(-127, 128, (3, 3, C, C), dtype=np.int8) for _ in range(2)]
    w_scale = [rng.uniform(5e-4, 1.5e-3, C).astype(np.float32) for _ in range(2)]
    act = [np.float32(2.0 ** -6), np.float32(1.0 / p2)]
    bn = [rng.uniform(0.5, 1.5, C).astype(np.float32), (rng.standard_normal(C) * 0.1).astype(np.float32),
          rng.uniform(0.5, 1.5, C).astype(np.float32), (rng.standard_normal(C) * 0.1).astype(np.float32)]
    be = {f'e{i + 1}': {'kernel_q': kq[i], 'w_scale': w_scale[i], 'act_scale': act[i]}
          for i in range(2)}
    be.update(bn1_scale=bn[0], bn1_shift=bn[1], bn2_scale=bn[2], bn2_shift=bn[3])
    port = {k: {kk: torch.as_tensor(vv) for kk, vv in v.items()} for k, v in be.items()
            if k in ('e1', 'e2')}
    params = ib.block_params(port['e1'], port['e2'], *(torch.as_tensor(v) for v in bn))
    w1, w2 = (torch.from_numpy(k.transpose(3, 0, 1, 2).copy()) for k in kq)  # HWIO -> [O,3,3,I]
    return be, w1, w2, params


RAGGED = [(1, 1, 1), (1, 1, 70), (1, 9, 1), (2, 13, 45), (1, 7, 65), (1, 6, 64), (3, 5, 130),
          (1, 12, 129)]


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', RAGGED + [(1, 72, 320)], ids=lambda s: 'x'.join(map(str, s)))
def test_k8_tiles_equal_the_plain_block_and_jax(shape, out_dtype):
    b, h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    be, w1, w2, params = _block(rng)
    xq_np = rng.integers(-60, 61, (b, h, w, C), dtype=np.int8)
    xq = torch.from_numpy(xq_np)
    plan = ib.block_plan(b, h, w)
    got = k8_by_tiles(xq, w1, w2, params, out_dtype, plan)
    ref = ib.int8_basic_block_plain(xq, w1, w2, params, out_dtype)
    assert torch.equal(got, ref)
    if ref.numel() >= 4096:  # a real mix of levels, not all zeros
        assert 0.1 < float((ref.float() > 0).float().mean()) < 0.9
    # the JAX package's kernel (interpret mode) quantizes a float input:
    # xq * act1, act1 a power of two; XLA's CPU code fuses its affines' multiply
    # and add, so it equals the same order of work with one rounding there
    x = xq_np.astype(np.float32) * be['e1']['act_scale']
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    jax_out = np.asarray(int8_basic_block_fused(jnp.asarray(x), be, jdt).astype(jnp.float32))
    fused = k8_by_tiles(xq, w1, w2, params, out_dtype, plan, fma=True)
    np.testing.assert_array_equal(fused.float().numpy(), jax_out)


def test_k8_tiles_saturate_and_zero_as_the_plain_block():
    """A requantize scale that drives most of h past +127 and an input of
    +-127: the clip, the halo's zeros and the residual at its extremes."""
    rng = np.random.default_rng(7)
    _, w1, w2, params = _block(rng, p2=400.0)
    xq = torch.from_numpy(rng.choice(np.array([-127, 0, 127], np.int8), (2, 7, 70, C)))
    plan = ib.block_plan(2, 7, 70)
    for dt in (torch.float32, torch.bfloat16):
        ref = ib.int8_basic_block_plain(xq, w1, w2, params, dt)
        assert torch.equal(k8_by_tiles(xq, w1, w2, params, dt, plan, seed=3), ref)
    hf = torch.clamp_min(ic.int8_conv2d_plain(xq, w1, padding=((1, 1), (1, 1))).float()
                         * params[0] + params[1], 0.0) * params[2]
    assert float((hf > 127.5).float().mean()) > 0.3


PLAN_SHAPES = [(32, 72, 320), (16, 72, 320), (1, 72, 320), (1, 1, 1), (2, 13, 45), (3, 5, 130),
               (1, 7, 65), (1, 600, 900)]


@pytest.mark.parametrize('sms', [132, 114, 8])
@pytest.mark.parametrize('shape', PLAN_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_block_plan_covers_every_pixel_once_within_the_card(shape, sms):
    b, h, w = shape
    plan = ib.block_plan(b, h, w, sms)
    seen = torch.zeros((b, h, w), dtype=torch.int32)
    for tile in range(plan.tiles):
        bi, r = divmod(tile, plan.tiles_y * plan.tiles_x)
        y0, x0 = (r // plan.tiles_x) * plan.tile_h, (r % plan.tiles_x) * plan.tile_w
        seen[bi, y0:y0 + plan.tile_h, x0:x0 + plan.tile_w] += 1
    assert bool((seen == 1).all())
    assert plan.grid == min(plan.tiles, sms) and 1 <= plan.grid <= sms
    assert plan.smem <= dc.SMEM_LIMIT  # 227 KB a block on sm_90
    # conv1's units cover the region; every tap of every unit reads inside
    # the staged planes, and conv2's rows read only what conv1 wrote
    p, th = plan.pitch, plan.tile_h
    assert 64 * plan.units1 >= (th + 2) * p
    assert 64 * plan.units1 - 1 + 2 * p + 2 < plan.x_positions
    assert (th + 1) * p + 2 + 63 < plan.h_positions and plan.units2 == th
    assert plan.tile_w + 2 <= p and 64 + 2 <= p  # a conv2 tap stays inside one hq row


def test_block_plan_by_hand():
    """Layer1 at batch 16 (the stereo pair: 32 x 72 x 320): 12 x 5 tiles of
    6 x 64 an image, 1920 tiles on 132 SMs; conv1 9 units over 8 x 68
    positions; shared memory: 2 x 36 KB of weights, 2 staged tiles of 4
    planes of 720 positions, hq 4 planes of 576, 3 stagings of 8 KB, 1.5 KB
    of parameters, 4 mbarriers, 128 bytes of alignment."""
    plan = ib.block_plan(32, 72, 320)
    assert (plan.tile_h, plan.tile_w, plan.pitch) == (6, 64, 68)
    assert (plan.tiles_y, plan.tiles_x, plan.tiles, plan.grid) == (12, 5, 1920, 132)
    assert (plan.units1, plan.units2, plan.x_positions, plan.h_positions) == (9, 6, 720, 576)
    assert plan.smem == 73728 + 92160 + 36864 + 24576 + 1536 + 32 + 128 == 229024
    assert plan.threads == 416
    assert ib.block_plan(1, 1, 1)[3:6] == (1, 1, 1)


def test_block_plan_mirrors_the_cuda_source():
    src = (kernel_build.CSRC_DIR / 'int8_block.cu').read_text()
    th, tw = map(int, re.search(r'constexpr int TH = (\d+), TW = (\d+);', src).groups())
    assert (th, tw) == (ib.TILE_H, ib.TILE_W)
    assert 'constexpr int P = TW + 4;' in src and ib.PITCH == ib.TILE_W + 4
    assert int(re.search(r'constexpr int kWGs = (\d+);', src).group(1)) == ib.CONSUMER_WARPGROUPS
    assert 'constexpr int kSmem = kOffBar + 4 * 8 + 128;' in src


def _study():
    spec = importlib.util.spec_from_file_location(
        'int8_study', pathlib.Path(__file__).resolve().parent.parent / 'int8_study.py')
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    return study


@pytest.mark.parametrize('name', ['as_is', 'no_mma', 'mma_only', 'mma_conv1_epilogue',
                                  'mma_conv2_epilogue', 'deep3', 'float_clamp'])
def test_study_variants_match_the_source(name):
    """``int8_study.py variants`` edits the source by text: every anchor must
    still be in it once."""
    study = _study()
    assert sorted(study.VARIANTS) == sorted(['as_is', 'no_mma', 'mma_only', 'mma_conv1_epilogue',
                                             'mma_conv2_epilogue', 'deep3', 'float_clamp'])
    text = (kernel_build.CSRC_DIR / 'int8_block.cu').read_text()
    assert (study.substitute(text, study.VARIANTS[name]) != text) == (name != 'as_is')


# --------------------------------------------------------------------------
# the activation quantize


class QuantizePlan(NamedTuple):
    """How the quantize kernel splits one call (see :func:`quantize_plan`)."""
    head: int         # elements before x's first 16-byte boundary, one a thread
    n_vec: int        # vectors of QUANT_VEC elements: the body
    tail: int         # elements after the body, one a thread
    blocks: int       # blocks of QUANT_THREADS threads
    phase_step: int   # channels a thread's vector phase moves between its vectors (0: fixed)


QUANT_VEC = 16          # elements of a vector: one 16-byte store of s8
QUANT_THREADS = 256
QUANT_BLOCKS_PER_SM = 8


def quantize_plan(n: int, n_inv: int, x_address: int, itemsize: int,
                  sms: int = 132) -> QuantizePlan:
    """The quantize kernel's split of ``n`` elements, as ``launch_quantize``
    in ``csrc/int8_conv.cu`` makes it: a head up to x's first 16-byte boundary (all of x
    where its base is not element-aligned), ``n_vec`` vectors of 16, the
    tail; ``QUANT_BLOCKS_PER_SM`` blocks an SM at most; with a channel scale
    (``n_inv > 1``) the grid rounded down to a whole number of channel
    periods where that keeps at least half of it, so that a thread's
    channel phase is fixed (``phase_step == 0``)."""
    head = n if x_address % itemsize else (16 - x_address % 16) % 16 // itemsize
    head = min(head, n)
    n_vec = (n - head) // QUANT_VEC
    tail = n - head - n_vec * QUANT_VEC
    blocks = min(-(-max(n_vec, head + tail) // QUANT_THREADS), sms * QUANT_BLOCKS_PER_SM)
    blocks = max(blocks, 1)
    phase_step = 0
    if n_inv > 1:
        period = n_inv // math.gcd(n_inv, QUANT_VEC * QUANT_THREADS)
        if blocks >= period:
            blocks = blocks // period * period
        phase_step = QUANT_VEC * QUANT_THREADS * blocks % n_inv
    return QuantizePlan(head, n_vec, tail, blocks, phase_step)


def quantize_by_plan(x, inv, plan):
    """The quantize kernel's split in torch: scalar head and tail; the body
    in vectors of 16, thread ``tid`` taking vectors tid, tid + T, ...; a
    thread's channel phase computed once, then moved by ``phase_step`` and
    wrapped; the 16 scales of a vector by a wrapping counter."""
    flat = x.reshape(-1).float()
    invf = inv.reshape(-1).float()
    n, n_inv = flat.numel(), invf.numel()
    out = torch.zeros((n,), dtype=torch.int8)
    written = torch.zeros((n,), dtype=torch.int32)

    def q(vals, scales):
        return torch.clamp(torch.round(vals * scales), -127, 127).to(torch.int8)

    vec = QUANT_VEC
    tail0 = plan.head + plan.n_vec * vec
    idx = torch.cat([torch.arange(plan.head), torch.arange(tail0, n)])
    assert len(idx) == plan.head + plan.tail
    out[idx] = q(flat[idx], invf[idx % n_inv])
    written[idx] += 1
    threads = plan.blocks * QUANT_THREADS
    v = torch.arange(min(threads, plan.n_vec))
    c = (plan.head + vec * v) % n_inv
    while len(v):
        assert torch.equal(c, (plan.head + vec * v) % n_inv)
        scales = torch.empty((len(v), vec))
        ce = c.clone()
        for e in range(vec):
            scales[:, e] = invf[ce]
            ce += 1
            ce[ce == n_inv] = 0
        elems = plan.head + vec * v[:, None] + torch.arange(vec)
        out[elems.reshape(-1)] = q(flat[elems], scales).reshape(-1)
        written[elems.reshape(-1)] += 1
        c = c + plan.phase_step
        c[c >= n_inv] -= n_inv
        keep = v + threads < plan.n_vec
        v, c = v[keep] + threads, c[keep]
    assert bool((written == 1).all())  # every element once
    return out.reshape(x.shape)


def _special_values(rng, n, dtype):
    """Values with exact .5 ties after a multiply by a power of two,
    saturating values and -0.0 among standard-normal ones."""
    x = rng.standard_normal(n).astype(np.float32) * 40
    k = rng.integers(-300, 300, n)
    ties = rng.random(n) < 0.3
    x[ties] = k[ties] + 0.5                      # ties (times inv = 1) or quarter ties
    x[rng.random(n) < 0.05] = 1e4                 # saturates
    x[rng.random(n) < 0.05] = -1e4
    x[rng.random(n) < 0.05] = -0.0
    specials = [0.5, 2.5, -2.5, 1e4, -1e4, -0.0, 126.5, 127.5, -127.5, 1.5, -0.5]
    x[3:3 + len(specials)] = specials[:max(0, n - 3)]
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'base+1'])
@pytest.mark.parametrize('n_inv,rows', [(1, 1001), (1, 7), (64, 37), (72, 19), (1408, 3)])
def test_quantize_split_equals_the_plain_version_and_jax(n_inv, rows, offset, dtype):
    rng = np.random.default_rng(n_inv + rows + offset)
    n = rows * (n_inv if n_inv > 1 else 1) + (5 if n_inv == 1 else 0)
    big = _special_values(rng, n + offset + 3, dtype)
    x = big[offset:offset + n]
    if n_inv > 1:
        x = x.view(rows, n_inv)
    assert x.is_contiguous() and (x.data_ptr() - big.data_ptr()) == offset * x.element_size()
    act = (rng.choice(np.array([0.5, 1.0, 2.0, 0.25], np.float32), n_inv) if n_inv > 1
           else np.array(1.0, np.float32))
    if n_inv > 1:
        act[:1] = 1.0  # a channel where the ties survive the multiply
    inv = 1.0 / torch.from_numpy(act)  # f32 division, as JAX forms 1 / act_scale
    ref = ic.quantize_act_plain(x, inv)
    for sms in (132, 1):  # the card's grid, and a grid of few threads (many vectors each)
        plan = quantize_plan(x.numel(), n_inv, x.data_ptr(), x.element_size(), sms)
        assert plan.head + plan.n_vec * QUANT_VEC + plan.tail == x.numel()
        if offset == 0 and x.data_ptr() % 16 == 0:
            assert plan.head == 0
        assert torch.equal(quantize_by_plan(x, inv, plan), ref)
    jax_ref = np.asarray(jax_quant._quantize_act(jnp.asarray(x.float().numpy()), jnp.asarray(act)))
    np.testing.assert_array_equal(ref.numpy(), jax_ref)
    flat = x.reshape(-1).float()
    assert bool(((flat.abs() % 1) == 0.5).any()) and int((ref == 127).sum()) > 0
    assert int((ref == -127).sum()) > 0 and bool((torch.signbit(flat) & (flat == 0)).any())


@pytest.mark.parametrize('n_inv', [1, 64, 72, 1408, 96, 1152])
def test_quantize_plan_fixes_the_channel_phase_on_the_card(n_inv):
    """At the stereo predict's sizes the grid is a whole number of channel
    periods, so each thread's scales stay in registers (phase_step 0), and
    it keeps at least half the blocks the work or 8 blocks an SM ask for."""
    n = 16 * 18 * 80 * n_inv if n_inv > 1 else 32 * 72 * 320 * 64
    plan = quantize_plan(n, n_inv, 0, 2, 132)
    assert plan.phase_step == 0 and plan.head == plan.tail == 0
    cap = min(-(-plan.n_vec // QUANT_THREADS), 132 * QUANT_BLOCKS_PER_SM)
    assert cap // 2 <= plan.blocks <= cap
    period = n_inv // math.gcd(n_inv, QUANT_VEC * QUANT_THREADS)
    assert plan.blocks % period == 0


def test_quantize_plan_mirrors_the_cuda_source():
    src = (kernel_build.CSRC_DIR / 'int8_conv.cu').read_text()
    for name, value in (('kQVec', QUANT_VEC), ('kQThreads', QUANT_THREADS),
                        ('kQBlocksPerSm', QUANT_BLOCKS_PER_SM)):
        assert re.search(rf'constexpr int {name} = {value};', src), name
    # an unaligned or not element-aligned base: the head up to the boundary, or everything
    assert quantize_plan(100, 1, 2, 2).head == 7
    assert quantize_plan(100, 1, 4, 4).head == 3
    assert quantize_plan(100, 1, 1, 2) == QuantizePlan(100, 0, 0, 1, 0)
