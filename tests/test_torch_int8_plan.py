"""The plan of the int8 conv kernel B8 (``ops/int8_conv.plan_int8_conv``)
and its split K, on the CPU.

The wgmma kernel cannot run here; what it is told to do is plain Python,
which these tests hold to its rules: every split covers K exactly once, a
split grid fills the card (132 SMs), K is split only where that was
measured to pay (few tiles and a long K), shapes the TMA unit cannot take
go to the cp.async path. A torch transcription of split K (s32 partial sums
over the plan's K slices, added, then the epilogue) equals the plain
convolution bit for bit.
"""
import itertools

import numpy as np
import pytest
import torch

from visualdet3d_tpu_torch.ops import int8_conv as ic

PAD1 = ((1, 1), (1, 1))
# (B, H, W, C_in, C_out) of the 3x3 stride-1 convs of the batch-16 int8
# stereo predict at 288x1280 (the left and right images share the trunk)
STEREO_SHAPES = (
    (32, 72, 320, 64, 64), (32, 36, 160, 128, 128), (32, 18, 80, 256, 256),
    (16, 36, 160, 72, 72), (16, 36, 160, 96, 96), (16, 18, 80, 256, 144),
    (16, 18, 80, 256, 256), (16, 18, 80, 288, 288), (16, 18, 80, 384, 384),
    (16, 18, 80, 1152, 1152), (16, 18, 80, 1408, 256), (16, 18, 80, 1408, 576),
    (16, 18, 80, 1408, 1408))
# the same convs in the batch-1 predict
STEREO_SHAPES_BS1 = tuple((b // 16, h, w, c, n) for b, h, w, c, n in STEREO_SHAPES)
# (B, H, W, C_in, C_out, k, padding): K9(a), the s8 GEMM [2560, 576] x [576, 64]
K9A = (1, 1, 2560, 576, 64, 1, ((0, 0), (0, 0)))
PLAN_SHAPES = [(*s, 3, PAD1) for s in STEREO_SHAPES + STEREO_SHAPES_BS1] + [K9A]


def _plan(b, h, w, c, n, k, pad, **kw):
    return ic.plan_int8_conv(b, h, w, c, n, k, k, (1, 1), pad, (1, 1), **kw)


@pytest.mark.parametrize('split_k', [None, True], ids=['as planned', 'split forced'])
@pytest.mark.parametrize('shape', PLAN_SHAPES, ids=lambda s: 'x'.join(map(str, s[:5])))
def test_plan_covers_k_once_and_fills_the_card(shape, split_k):
    b, h, w, c, n, k, pad = shape
    plan = _plan(*shape, split_k=split_k)
    if c % 16:
        assert plan.path == 'cp_async'
        return
    assert plan.path == 'wgmma' and plan.box_h * plan.box_w == 64
    # every (tap, channel) of K in exactly one split
    seen = {}
    for s, steps in enumerate(ic.split_k_ranges(plan, c)):
        assert steps, f'split {s} is empty'
        for tap, c0, c1 in steps:
            for ch in range(c0, c1):
                assert (tap, ch) not in seen
                seen[tap, ch] = s
    assert set(seen) == set(itertools.product(range(k * k), range(c)))
    # a split grid reaches the card's 132 SMs, or every block takes one K
    # step; as planned, K is split only where the tiles fill at most a third
    # of the SMs and K has SPLIT_MIN_K_STEPS steps or more
    tiles = plan.m_tiles * plan.n_tiles
    assert plan.grid == tiles * plan.split
    assert plan.split == 1 or plan.grid >= ic.SMS or plan.steps_per_split == 1
    assert (plan.split > 1) == (tiles < ic.SMS and (
        split_k or (3 * tiles <= ic.SMS and plan.k_steps >= ic.SPLIT_MIN_K_STEPS)))
    # the boxes and N tiles cover the output
    ho, wo = ic.output_hw(h, w, k, k, (1, 1), pad, (1, 1))
    per_image = -(-ho // plan.box_h) * -(-wo // plan.box_w)
    assert plan.m_tiles == -(-(b * per_image) // 2)
    assert plan.n_tiles * plan.bn >= n > (plan.n_tiles - 1) * plan.bn


def test_plan_of_the_stereo_predict():
    """The shapes of the main path: all but the C_in = 72 convs on the wgmma
    path, none split at batch 16; at batch 1 split K only for the two shapes
    where it was measured to pay (288 -> 288 and 1408 -> 256: a K of 81 and
    99 steps over 39 and 13 tiles); K9(a) unsplit, 20 blocks of 9 steps."""
    paths = {s: _plan(*s, 3, PAD1).path for s in STEREO_SHAPES}
    assert [s for s, p in paths.items() if p == 'cp_async'] == [(16, 36, 160, 72, 72)]
    assert all(_plan(*s, 3, PAD1).split == 1 for s in STEREO_SHAPES)
    split = {s: _plan(*s, 3, PAD1).split for s in STEREO_SHAPES_BS1}
    assert {s: v for s, v in split.items() if v > 1} == {
        (1, 18, 80, 288, 288): 5, (1, 18, 80, 1408, 256): 11}
    k9 = _plan(*K9A)
    assert (k9.box_h, k9.box_w, k9.bk, k9.bn, k9.split, k9.grid) == (1, 64, 64, 64, 1, 20)


@pytest.mark.parametrize('shape', [(*s, 3, PAD1) for s in STEREO_SHAPES_BS1] + [K9A],
                         ids=lambda s: 'x'.join(map(str, s[:5])))
def test_plan_split_k_override(shape):
    """split_k=False never splits; split_k=True splits wherever the tiles
    are fewer than the SMs; both keep the path, boxes and tiles."""
    planned = _plan(*shape)
    never, forced = _plan(*shape, split_k=False), _plan(*shape, split_k=True)
    assert never.split == 1 and never.steps_per_split == never.k_steps
    if planned.path == 'wgmma':
        assert (forced.split > 1) == (forced.m_tiles * forced.n_tiles < ic.SMS)
    for p in (never, forced):
        assert p._replace(grid=0, split=1, steps_per_split=0) == \
            planned._replace(grid=0, split=1, steps_per_split=0)


@pytest.mark.parametrize('case', [
    dict(c=72), dict(c=16), dict(c=8), dict(stride=(2, 2)), dict(aligned=False)],
    ids=['C_in 72', 'C_in 16', 'C_in 8', 'stride 2', 'unaligned base'])
def test_plan_sends_what_tma_cannot_take_to_cp_async(case):
    c = case.get('c', 64)
    plan = ic.plan_int8_conv(2, 9, 11, c, 64, 3, 3, case.get('stride', (1, 1)), PAD1, (1, 1),
                             aligned=case.get('aligned', True))
    assert plan.path == 'cp_async' and plan.grid > 0


def _split_k(xq, wq, plan, padding, dilation):
    """The kernel's split K in torch: per split, the s32 partial sum of its
    (tap, channel range) steps (each a shifted 1x1 conv of the channel
    slice, exact in float64), then the splits added in int64."""
    b, h, w, c = xq.shape
    n, kh, kw, _ = wq.shape
    (pt, pb), (pl, pr) = padding
    ho, wo = ic.output_hw(h, w, kh, kw, (1, 1), padding, dilation)
    xp = torch.nn.functional.pad(xq.double(), (0, 0, pl, pr, pt, pb))
    total = torch.zeros((b, ho, wo, n), dtype=torch.int64)
    for steps in ic.split_k_ranges(plan, c):
        part = torch.zeros((b, ho, wo, n), dtype=torch.float64)
        for tap, c0, c1 in steps:
            ky, kx = divmod(tap, kw)
            window = xp[:, ky * dilation[0]:ky * dilation[0] + ho,
                        kx * dilation[1]:kx * dilation[1] + wo, c0:c1]
            part += window @ wq[:, ky, kx, c0:c1].double().T
        total += part.round().long()
    return total.to(torch.int32)


@pytest.mark.parametrize('shape', [
    (1, 1, 640, 576, 64, 1, ((0, 0), (0, 0)), (1, 1)),
    (2, 7, 9, 48, 70, 3, PAD1, (1, 1)),
    (1, 6, 20, 288, 96, 3, PAD1, (1, 1)),
    (2, 13, 29, 128, 40, 3, ((3, 2), (1, 3)), (2, 2))],
    ids=['1x1 C_in 576', 'C_in 48 tail', 'C_in 288', 'padding 3 dilation 2'])
def test_split_k_formulation_equals_the_plain_conv(shape):
    """The s32 sums of the plan's K slices, added, equal the plain sums bit
    for bit (integers: exact in any order), and the f32 and bf16 epilogues
    applied to the full sum equal the plain version's."""
    b, h, w, c, n, k, pad, dil = shape
    plan = ic.plan_int8_conv(b, h, w, c, n, k, k, (1, 1), pad, dil, split_k=True)
    assert plan.path == 'wgmma' and plan.split > 1
    rng = np.random.default_rng(7)
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k, k, c), dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    acc = _split_k(xq, wq, plan, pad, dil)
    ref = ic.int8_conv2d_plain(xq, wq, (1, 1), pad, dil)
    assert torch.equal(acc, ref)
    for dtype in (torch.float32, torch.bfloat16):
        want = ic.int8_conv2d_plain(xq, wq, (1, 1), pad, dil, scale, bias, dtype)
        assert torch.equal((acc.float() * scale + bias).to(dtype), want)
