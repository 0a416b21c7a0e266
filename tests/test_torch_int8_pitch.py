"""The int8 conv's channel pitch (``ops/int8_conv.py``) on the CPU.

Every int8 conv of the networks runs on one kernel (``csrc/int8_conv.cu``),
whose TMA loads need 16-byte strides: a pixel's C_in channels are stored in
``channel_pitch(C_in)`` bytes (a multiple of 16, at least 32) with a zero
tail, written so by the quantize and kept so by ``Int8Conv2d``'s weights.
The kernels cannot run here; their plain versions take the same layout, and
these tests hold them to the JAX package:

* the pitched quantize equals JAX's ``_quantize_act`` followed by zeros to
  the pitch, bit for bit, at C_in 9, 72 and 1025 (f32 and bf16 inputs,
  per-tensor and per-channel scales);
* the pitched s32 sums equal the JAX package's ``_int8_conv`` (XLA's s8
  ``conv_general_dilated``, s32 accumulation) exactly, at C_in 25 and 72
  (3x3) and 1025 (1x1 on a 2x3 map);
* the plan takes every conv shape of the int8 predicts (Stereo3D, KM3D,
  MonoFlex, GAC, Yolo3D; batch 16 and 1) with a launch the kernel's entry
  accepts, K covered once;
* ``Int8Conv2d`` at GAC's ``LookGround`` 1x1 conv (1025 -> 1024) stays
  within the int8 bridge gate of ``tests/test_torch_int8.py`` of JAX's
  output;
* the layout the kernel refuses: a pitch off 16 or under 32, a base off 16
  bytes, a pitch the weights do not share;
* ``int8_study.py params``' substitutions match the conv source, whose
  kernel parameter struct stays within 128 bytes.

On the card, ``chip_smoke.py`` (``int8_conv_edges``) holds the kernels
against these plain versions bit for bit.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import linen as flax_nn

from visualdet3d_tpu.models import quant as jq
from visualdet3d_tpu_torch.models.blocks import FlaxConv2d
from visualdet3d_tpu_torch.models.quant import Int8Conv2d, quantize_weight
from visualdet3d_tpu_torch.ops import int8_conv as ic

from test_torch_int8 import _bridge_gate
from test_torch_int8_plan import STEREO_SHAPES, STEREO_SHAPES_BS1

# (H, W, C_in, C_out, k) of the int8 convs of the batch-16 mono predicts, all
# stride 1 (3x3 padding 1, 1x1 none), from forward hooks on the published
# models (KM3D and MonoFlex 384x1280, GAC and Yolo3D 288x1280) under the
# 64-channel bound and each model's deny list
DLA34_SHAPES = (
    (12, 40, 256, 512, 1), (12, 40, 512, 512, 3), (12, 40, 1280, 512, 1),
    (24, 80, 128, 256, 1), (24, 80, 256, 256, 3), (24, 80, 512, 256, 1), (24, 80, 896, 256, 1),
    (48, 160, 64, 128, 1), (48, 160, 128, 128, 3), (48, 160, 256, 128, 1),
    (48, 160, 448, 128, 1), (96, 320, 64, 64, 3), (96, 320, 64, 256, 3), (96, 320, 128, 64, 1))
RESNET101_SHAPES = (
    (18, 80, 256, 256, 3), (18, 80, 256, 1024, 1), (18, 80, 512, 512, 3),
    (18, 80, 1024, 256, 1), (18, 80, 1024, 512, 3), (18, 80, 1024, 1024, 3),
    (36, 160, 128, 128, 3), (36, 160, 128, 512, 1), (36, 160, 512, 128, 1),
    (36, 160, 512, 256, 1), (72, 320, 64, 64, 1), (72, 320, 64, 64, 3), (72, 320, 64, 256, 1),
    (72, 320, 256, 64, 1), (72, 320, 256, 128, 1))
LOOKGROUND = (18, 80, 1025, 1024, 1)  # GAC's LookGround Conv_1
FAMILIES = {  # (B, H, W, C_in, C_out, k) at batch 16 and 1
    'stereo': tuple((*s, 3) for s in STEREO_SHAPES + STEREO_SHAPES_BS1),
    **{model: tuple((b, *s) for b in (16, 1) for s in shapes) for model, shapes in (
        ('km3d', DLA34_SHAPES), ('monoflex', DLA34_SHAPES),
        ('gac', RESNET101_SHAPES + (LOOKGROUND,)), ('yolo3d', RESNET101_SHAPES))},
}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('c', [9, 72, 1025])
def test_pitched_quantize_equals_jax_then_zero_tail(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 3, 5, c)).astype(np.float32) * 40
    x.reshape(-1)[:5] = [0.5, 2.5, -2.5, -0.0, 1e4]  # ties and saturation
    act = np.float32(0.37)
    per_channel = (rng.random(c).astype(np.float32) + 0.5)
    pitch = ic.channel_pitch(c)
    assert pitch % 16 == 0 and pitch >= max(c, 32) and pitch - c < 16 + max(0, 32 - c)
    for xt in (torch.from_numpy(x), torch.from_numpy(x).to(torch.bfloat16)):
        for inv, jax_scale in ((1.0 / torch.tensor(act), act),
                               (torch.from_numpy(per_channel), 1.0 / per_channel)):
            got = ic.quantize_act(xt, inv, pitch)
            assert got.dtype == torch.int8 and got.shape == (2, 3, 5, pitch)
            assert not got[..., c:].any()
            assert torch.equal(got, ic.quantize_act_plain(xt, inv, pitch))
            if inv.dim() == 0:  # JAX's own scale: x * (1 / act_scale)
                ref = np.asarray(jq._quantize_act(jnp.asarray(xt.float().numpy()),
                                                  jnp.asarray(jax_scale)))
                np.testing.assert_array_equal(got[..., :c].numpy(), ref)
            else:
                np.testing.assert_array_equal(got[..., :c].numpy(),
                                              ic.quantize_act_plain(xt, inv).numpy())


@pytest.mark.parametrize('c,k,hw', [(25, 3, (5, 7)), (72, 3, (5, 7)), (1025, 1, (2, 3))],
                         ids=['C_in 25 3x3', 'C_in 72 3x3', 'C_in 1025 1x1'])
def test_pitched_sums_equal_jax_int8_conv(c, k, hw):
    """On the integer grid with unit scales JAX's ``_int8_conv`` returns its
    s32 sums as f32, exact below 2**24 (here at most 9 * 72 * 127**2)."""
    rng = np.random.default_rng(c + k)
    n = 40
    x = rng.integers(-127, 128, (2, *hw, c)).astype(np.float32)
    kq = rng.integers(-127, 128, (k, k, c, n), dtype=np.int8)
    entry = {'kernel_q': jnp.asarray(kq), 'w_scale': jnp.ones((n,), jnp.float32),
             'act_scale': jnp.float32(1.0)}
    ref = np.asarray(jq._int8_conv(flax_nn.Conv(n, (k, k)), jnp.asarray(x), entry, jnp.float32))
    pitch = ic.channel_pitch(c)
    xq = ic.quantize_act(torch.from_numpy(x), torch.tensor(1.0), pitch)
    wq = ic.pad_channels(torch.from_numpy(kq.transpose(3, 0, 1, 2)), pitch)
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    acc = ic.int8_conv2d(xq, wq, padding=pad, c_in=c)
    assert acc.dtype == torch.int32 and acc.shape == (2, *hw, n)
    np.testing.assert_array_equal(acc.numpy().astype(np.float32), ref)
    # the f32 epilogue on the pitched layout equals JAX's
    scale = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    entry['w_scale'] = jnp.asarray(scale)
    ref = np.asarray(jq._int8_conv(flax_nn.Conv(n, (k, k)), jnp.asarray(x), entry, jnp.float32))
    got = ic.int8_conv2d(xq, wq, padding=pad, scale=torch.from_numpy(scale),
                         out_dtype=torch.float32, c_in=c)
    np.testing.assert_array_equal(got.numpy(), ref)


def _launchable(plan, b, h, w, c, n, k):
    """The conditions of the kernel's entry (``vd3d_int8_conv2d_wgmma``) on
    what the wrapper passes for this plan."""
    pitch = ic.channel_pitch(c)
    vb, vh, vw = plan.view
    assert vb * vh * vw == b * h * w
    assert pitch % 16 == 0 and pitch >= max(c, 32)
    assert plan.box_h * plan.box_w == 64 and plan.bk in (32, 64, 128) and plan.bn in ic.TILE_NS
    # 3 stages only for 128-channel tiles on 128-byte chunks and a short K
    # (two blocks an SM), else 4
    assert plan.stages == 4 or (plan.stages, plan.bn, plan.bk) == (3, 128, 128) and \
        plan.k_steps <= ic.SHORT_K_STEPS
    assert plan.chunks == -(-c // plan.bk) and plan.k_steps == k * k * plan.chunks
    assert plan.split * plan.steps_per_split >= plan.k_steps
    assert (plan.split - 1) * plan.steps_per_split < plan.k_steps


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_plan_takes_every_conv_of_the_int8_predicts(family):
    """Every int8 conv shape of the family's predicts at batch 16 and 1 has
    a launch the kernel takes, and its splits cover (tap, channel) once."""
    for b, h, w, c, n, k in FAMILIES[family]:
        pad = ((k // 2, k // 2), (k // 2, k // 2))
        plan = ic.plan_int8_conv(b, h, w, c, n, k, k, (1, 1), pad, (1, 1))
        _launchable(plan, b, h, w, c, n, k)
        seen = [(tap, ch) for steps in ic.split_k_ranges(plan, c)
                for tap, c0, c1 in steps for ch in range(c0, c1)]
        assert sorted(seen) == list(itertools.product(range(k * k), range(c)))


def test_int8_conv2d_lookground_gac_within_the_bridge_gate():
    """GAC's ``LookGround`` ``Conv_1`` (1025 -> 1024, 1x1): ``Int8Conv2d``
    keeps the artifact's weights on the 1040-byte pitch with a zero tail,
    and its output on a 2x3 map is JAX's ``_int8_conv`` on the same
    artifact within the bridge gate."""
    torch.manual_seed(3)
    conv = FlaxConv2d(1025, 1024, 1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2, 3, 1025)).astype(np.float32)
    k_q, w_scale = quantize_weight(conv.weight.detach())
    entry = {'kernel_q': k_q, 'w_scale': w_scale,
             'act_scale': torch.tensor(np.float32(np.abs(x).max() / 127)),
             'bias': conv.bias.detach().clone()}
    mod = Int8Conv2d(conv, entry, torch.float32)
    assert (mod.c_in, mod.pitch, tuple(mod.kernel_q.shape)) == (1025, 1040, (1024, 1, 1, 1040))
    assert torch.equal(mod.kernel_q[..., :1025], k_q) and not mod.kernel_q[..., 1025:].any()
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = mod(x_nchw).permute(0, 2, 3, 1).detach().numpy()
    jentry = {'kernel_q': jnp.asarray(k_q.numpy().transpose(1, 2, 3, 0)),
              'w_scale': jnp.asarray(w_scale.numpy()), 'act_scale': jnp.asarray(entry['act_scale']),
              'bias': jnp.asarray(entry['bias'].numpy())}
    ref = np.asarray(jq._int8_conv(flax_nn.Conv(1024, (1, 1)), jnp.asarray(x), jentry,
                                   jnp.float32))
    _bridge_gate(got, ref, 'LookGround Conv_1')


def test_the_layout_the_kernel_refuses():
    for pitch, c in ((72, 72), (16, 9), (1025, 1025)):
        with pytest.raises(ValueError, match='a multiple of 16, at least 32'):
            ic.check_kernel_layout(torch.zeros((1, 2, 2, pitch), dtype=torch.int8), c)
    base = torch.zeros(4 * 32 + 16, dtype=torch.int8)
    with pytest.raises(ValueError, match='16-byte boundary'):
        ic.check_kernel_layout(base[8:8 + 4 * 32].view(1, 2, 2, 32), 32)
    with pytest.raises(ValueError, match='a multiple of 16'):
        ic.quantize_act(torch.ones((2, 9)), torch.tensor(1.0), 24)
    with pytest.raises(ValueError, match='a multiple of 16'):
        ic.quantize_act(torch.ones((2, 40)), torch.tensor(1.0), 32)
    with pytest.raises(NotImplementedError, match='at most 8'):
        ic.plan_int8_conv(1, 40, 40, 64, 64, 3, 3, (9, 9))
    wide = ic.plan_int8_conv(1, 8, 2100, 64, 64, 1, 1, (8, 8))
    assert wide.box_w * 8 <= 256 and wide.box_h * 8 <= 256
    xq = torch.zeros((1, 4, 4, 80), dtype=torch.int8)
    with pytest.raises(ValueError, match='weights pitch'):
        ic.int8_conv2d(xq, torch.zeros((8, 3, 3, 72), dtype=torch.int8), c_in=72)
    with pytest.raises(ValueError, match='weights pitch'):
        ic.int8_conv2d(xq, torch.zeros((8, 3, 3, 80), dtype=torch.int8), c_in=81)


def test_int8_study_params_anchors_in_the_conv_source():
    """``int8_study.py params`` grows the kernel's parameter struct by text:
    each substitution matches the source once, and the struct as it is
    stays within the 128 bytes its ``static_assert`` holds it to."""
    import re

    import int8_study

    text = int8_study.CONV_SRC.read_text()
    for old, _ in int8_study.PARAMS_PLUS_ONE:
        assert text.count(old) == 1, old
    body = text[text.index('struct TmaConv {'):]
    body = body[:body.index('};')]
    pointers = len(re.findall(r'\*\s*\w+;', body))
    ints = sum(len(line.split('int ', 1)[1].split(';')[0].split(','))
               for line in body.splitlines() if line.strip().startswith('int '))
    assert (pointers, 8 * pointers + 4 * ints) == (4, 128)
