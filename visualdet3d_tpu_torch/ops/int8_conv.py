"""int8 convolution (counterpart of the s8 ``conv_general_dilated`` calls of
``visualdet3d_tpu/models/quant.py``: ``_int8_conv``, ``_conv3x3_s8`` and the
stride-2 ``_s2d_conv_int8``, whose s32 result is the direct stride-2 conv's).

Layouts: the quantized input ``xq`` is NHWC s8 (the port's channels_last
activations permuted), the weights ``wq`` are ``[C_out, kh, kw, C_in]`` s8
(an OIHW kernel in channels_last memory; the bridge turns the JAX package's
HWIO ``kernel_q`` into it), the output NHWC. ``padding`` is
``((top, bottom), (left, right))``. Channels may be stored with a pitch:
``[..., pitch]`` with ``c_in`` of them used (:func:`channel_pitch`: a
multiple of 16, the TMA unit's stride unit, and at least 32, one k32 step of
wgmma; ``Int8Conv2d`` keeps its weights so, with a zero tail, and
:func:`quantize_act` writes its output so).

The convolution is the hand-written CUDA kernel ``csrc/int8_conv.cu``, an
implicit GEMM on the int8 tensor cores with s32 accumulation and three
epilogues: the raw s32 sums, or ``acc * scale (+ bias)`` in f32, optionally
rounded to bf16 (``scale = w_scale * act_scale``, formed in f32 by the
caller as JAX forms it). Every shape runs on it, with the tiles and split
of :func:`plan_int8_conv`: TMA loads of shifted (and, at stride 2, strided)
boxes of the input and of the weights, ``wgmma`` on two consumer
warpgroups, split K where few tiles meet a long K. The activation quantize
that feeds it is a second kernel of the same source, one pass instead of
torch's five. The wrappers take the plain PyTorch versions only for tensors
on the CPU; a CUDA tensor launches the kernel or raises. Launches are
counted in ``LAUNCHES``: ``int8_conv2d`` for every conv, split or not.

The plain version computes the s32 sums as a float64 convolution of the
integer values: every partial sum is an integer below 2**53
(|acc| <= kh*kw*C_in*127**2), so the result is exact in any summation order,
and rounds back to int32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from visualdet3d_tpu_torch.ops import kernel_build

# launches of the CUDA kernels: every conv, then the convs without and with
# split K, and the quantize; reset with reset_launch_counts()
LAUNCHES = {'int8_conv2d': 0, 'int8_conv2d_wgmma': 0, 'int8_conv2d_wgmma_splitk': 0,
            'int8_quantize': 0}

SMS = 132  # streaming multiprocessors of an H100 SXM: the plan's default
BOX_WIDTHS = (64, 32, 16, 8)  # box widths of 64-pixel A boxes (height 64 / width)
TILE_NS = (64, 128, 256)      # output channels of a block
MAX_STRIDE = 8                # the TMA unit's largest element stride
SMEM_PER_SM = 233472          # shared memory of an H100 SM, bytes (228 KB)
# a 3-stage ring (two blocks an SM) pays only where a tile's K runs few
# steps and filling the ring is most of a tile's time (int8_study.py b8, on
# an H100: 15-20% faster at 9 steps, 0.6-5.6% slower at 27 and 99)
SHORT_K_STEPS = 16
# split K pays where the tiles fill at most a third of the SMs and each
# block would run SPLIT_MIN_K_STEPS or more K steps alone (chip_smoke.py
# int8_plan, on an H100: elsewhere the unsplit kernel is faster on the
# device and spares the zeroing and the finalize launch)
SPLIT_MIN_K_STEPS = 64

_EPILOGUE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def channel_pitch(c: int) -> int:
    """The bytes a pixel's ``c`` int8 channels are stored in for the conv
    kernel: ``c`` rounded up to a multiple of 16, and at least 32."""
    return max(32, -(-c // 16) * 16)


def pad_channels(t: torch.Tensor, pitch: int) -> torch.Tensor:
    """``t [..., c]`` with zeros appended to ``[..., pitch]``, contiguous."""
    return F.pad(t, (0, pitch - t.shape[-1])).contiguous()


def quantize_act_plain(x: torch.Tensor, inv_scale: torch.Tensor,
                       pitch: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantize_act`."""
    xq = torch.clamp(torch.round(x.float() * inv_scale), -127, 127).to(torch.int8)
    return xq if pitch is None else pad_channels(xq, pitch)


_QUANT_DTYPES = (torch.float32, torch.bfloat16)


def quantize_act(x: torch.Tensor, inv_scale: torch.Tensor,
                 pitch: Optional[int] = None) -> torch.Tensor:
    """Symmetric int8 quantization of an activation: ``x`` (f32 or bf16)
    times the f32 reciprocal of its scale (never a division: ``x / a`` and
    ``x * (1/a)`` differ by an ulp at round ties and flip int8 levels),
    rounded half to even, clipped to +-127. ``inv_scale`` is a scalar or one
    value per channel of the innermost axis. With ``pitch`` (a multiple of
    16, at least ``x.shape[-1]``) the output is ``[..., pitch]``, each
    pixel's channels followed by zeros: the conv kernel's layout. The CUDA
    kernel on the card (``x`` contiguous, any base); the plain version for
    CPU tensors.

    The wrapper is on the int8 predict's host path (one call a quantized
    conv), so it takes few host steps: the library's entry point is bound
    once, the stream is read raw, and a device context is entered only when
    ``x`` is not on the current device. Nothing that can go stale is kept."""
    c = x.shape[-1] if x.dim() else 1
    if pitch is not None and (pitch % 16 or pitch < c):
        raise ValueError(f'quantize_act: pitch {pitch} for {c} channels (a multiple of 16, '
                         f'at least the channels)')
    if x.device.type == 'cpu' and inv_scale.device.type == 'cpu':
        return quantize_act_plain(x, inv_scale, pitch)
    if x.dtype not in _QUANT_DTYPES:
        raise TypeError(f'quantize_act: the kernel takes float32 or bfloat16, got {x.dtype}')
    if x.device.type != 'cuda' or not x.is_contiguous():
        raise ValueError(f'quantize_act: expected a contiguous CUDA tensor, got one on '
                         f'{x.device} with strides {x.stride()}')
    _check(inv_scale, 'quantize_act(inv_scale)', torch.float32, inv_scale.dim())
    n_inv = inv_scale.numel()
    if inv_scale.dim() > 1 or (n_inv > 1 and (x.dim() == 0 or x.shape[-1] != n_inv)):
        raise ValueError(f'quantize_act: inv_scale of shape {tuple(inv_scale.shape)} for x of '
                         f'shape {tuple(x.shape)}')
    index = x.get_device()
    if inv_scale.get_device() != index:
        raise ValueError(f'quantize_act: inv_scale on {inv_scale.device}, x on {x.device}')
    if pitch == c:
        pitch = None
    out = torch.empty(x.shape if pitch is None else (*x.shape[:-1], pitch), dtype=torch.int8,
                      device=x.device)
    if out.numel() == 0:
        return out
    if pitch is None:
        fn = _quantize_entry()
        args = (x.data_ptr(), inv_scale.data_ptr(), out.data_ptr(), out.numel(), n_inv,
                x.dtype is torch.bfloat16)
    else:
        fn = _int8_conv_lib().vd3d_int8_quantize_pitched
        args = (x.data_ptr(), inv_scale.data_ptr(), out.data_ptr(), x.numel() // c, c, pitch,
                n_inv, x.dtype is torch.bfloat16)
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f'int8 quantize kernel launch failed: '
                           f'{_int8_conv_lib().vd3d_cuda_error_string(rc).decode()} '
                           f'(cudaError {rc}); x {tuple(x.shape)} {x.dtype}')
    LAUNCHES['int8_quantize'] += 1
    return out


def output_hw(h: int, w: int, kh: int, kw: int, stride: Tuple[int, int], padding: Padding,
              dilation: Tuple[int, int]) -> Tuple[int, int]:
    (pt, pb), (pl, pr) = padding
    ho = (h + pt + pb - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (w + pl + pr - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    return ho, wo


class Int8ConvPlan(NamedTuple):
    """How :func:`int8_conv2d` runs one shape (see :func:`plan_int8_conv`)."""
    grid: int                # blocks launched
    view: Tuple[int, int, int]  # (B, H, W) the kernel walks
    box_h: int               # the 64-pixel A box of one consumer warpgroup
    box_w: int
    bk: int                  # bytes of K per step: a channel chunk of one tap
    bn: int                  # output channels of a block
    stages: int              # stages of the shared-memory ring
    chunks: int              # channel chunks per tap
    k_steps: int             # taps x chunks
    split: int               # blocks sharing one output tile's K steps
    steps_per_split: int
    m_tiles: int             # pairs of boxes
    n_tiles: int


def ring_stages(bn: int, bk: int, k_steps: int) -> int:
    """The stages of a block's ring: 4, or 3 where K runs at most
    :data:`SHORT_K_STEPS` steps and 3 stages let a second block onto the SM,
    so that more stages are in flight there (in practice 128-channel tiles
    on 128-byte chunks). The kernel runs at most one block of 256 output
    channels an SM and two of fewer; a block's shared memory is its ring or
    the epilogue's staging of 4-byte outputs, whichever is larger, with its
    barriers, the 1 KB alignment and the 1 KB the card reserves a block."""
    def in_flight(stages):
        ring = stages * (128 + bn) * bk
        block = max(ring, 128 * (4 * bn + 16)) + 16 * stages + 2048
        return min(1 if bn == 256 else 2, SMEM_PER_SM // block) * stages
    if k_steps > SHORT_K_STEPS:
        return 4
    return max((4, 3), key=lambda s: (in_flight(s), s))


def gemm_view(b: int, h: int, w: int, kh: int, kw: int, stride=(1, 1),
              padding: Padding = ((0, 0), (0, 0))) -> Tuple[int, int, int]:
    """The (B, H, W) the kernel walks: a 1x1 stride-1 conv without padding
    is a GEMM over the pixels, one row of B*H*W (its boxes cover M with no
    ragged edge); any other conv its own shape."""
    if (kh, kw) == (1, 1) and tuple(stride) == (1, 1) and padding == ((0, 0), (0, 0)):
        return 1, 1, b * h * w
    return b, h, w


@functools.lru_cache(maxsize=1024)
def plan_int8_conv(b: int, h: int, w: int, c: int, n: int, kh: int, kw: int,
                   stride=(1, 1), padding: Padding = ((0, 0), (0, 0)), dilation=(1, 1),
                   pitch: Optional[int] = None, sms: int = SMS,
                   split_k: Optional[bool] = None) -> Int8ConvPlan:
    """The tiles and split of one int8 conv, from its shape alone: ``c``
    input channels stored ``pitch`` apart (default :func:`channel_pitch`).

    The conv runs on ``view`` (:func:`gemm_view`). A block owns two boxes of
    64 output pixels, the box (``box_h x box_w``, a power-of-two width) that
    covers the output map with the fewest boxes (ties: the wider), and
    ``bn`` output channels, the one of :data:`TILE_NS` with the least
    ``tiles * (bn + 32)`` (the A tile is read once per N tile; ties: the
    wider). K runs as taps x channel chunks of ``bk`` = 128, 64 or 32
    bytes, the largest that divides the pitch, over the ``c`` channels (a
    chunk's tail past ``c`` is zero-filled); where none does (a pitch of
    an odd number of 16-byte words: C_in 72 -> 80, 1025 -> 1040), 128: on
    an H100 32-byte steps ran such a conv at about 1 us a step, latency the
    4-stage ring could not hide (``int8_study.py b8``). The ring has
    :func:`ring_stages` stages. Where
    split K pays (the tiles fill at most a third of ``sms`` and K has
    :data:`SPLIT_MIN_K_STEPS` steps or more), K is split into ``split`` runs
    of ``steps_per_split`` steps, enough for the grid to reach ``sms``
    blocks or, failing that, one step per block. ``split_k`` True or False
    overrides that rule (to measure it). A stride beyond
    :data:`MAX_STRIDE` raises ``NotImplementedError``."""
    stride = tuple(stride)
    if max(stride) > MAX_STRIDE:
        raise NotImplementedError(f'int8_conv2d: stride {stride}: the kernel strides its '
                                  f'boxes with the TMA unit, at most {MAX_STRIDE}')
    pitch = channel_pitch(c) if pitch is None else pitch
    view = gemm_view(b, h, w, kh, kw, stride, padding)
    ho, wo = output_hw(*view[1:], kh, kw, stride, padding, dilation)
    # the input box spans box_w * stride columns, at most the TMA unit's 256
    box_h, box_w = min(((64 // bw, bw) for bw in BOX_WIDTHS if bw * stride[1] <= 256),
                       key=lambda hw: (math.ceil(ho / hw[0]) * math.ceil(wo / hw[1]), -hw[1]))
    m_boxes = view[0] * math.ceil(ho / box_h) * math.ceil(wo / box_w)
    m_tiles = math.ceil(m_boxes / 2)
    bk = next((v for v in (128, 64, 32) if pitch % v == 0), 128)
    chunks = math.ceil(c / bk)
    bn = min(TILE_NS, key=lambda t: (math.ceil(n / t) * (t + 32), -t))
    n_tiles = math.ceil(n / bn)
    k_steps = kh * kw * chunks
    stages = ring_stages(bn, bk, k_steps)
    tiles = m_tiles * n_tiles
    per = k_steps
    if split_k is None:
        split_k = 3 * tiles <= sms and k_steps >= SPLIT_MIN_K_STEPS
    if tiles < sms and split_k:
        per = max(1, k_steps // math.ceil(sms / tiles))
    split = math.ceil(k_steps / per)
    return Int8ConvPlan(tiles * split, view, box_h, box_w, bk, bn, stages, chunks, k_steps, split,
                        per, m_tiles, n_tiles)


def split_k_ranges(plan: Int8ConvPlan, c: int) -> List[List[Tuple[int, int, int]]]:
    """The K slices of each split of a plan: per split, its steps as
    (tap, first channel, end channel), the channel range clipped to ``c``
    (a chunk's tail past ``c`` is the TMA unit's zero fill)."""
    out = []
    for s in range(plan.split):
        steps = range(s * plan.steps_per_split,
                      min(plan.k_steps, (s + 1) * plan.steps_per_split))
        out.append([(k // plan.chunks, (k % plan.chunks) * plan.bk,
                     min(c, (k % plan.chunks + 1) * plan.bk)) for k in steps])
    return out


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1),
                      padding: Padding = ((0, 0), (0, 0)), dilation=(1, 1),
                      scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.int32,
                      c_in: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the s32 sums exactly (a float64 conv of the
    integers over the first ``c_in`` channels of each pitch), then the
    epilogue ``acc.float() * scale``, ``+ bias``, cast to ``out_dtype``;
    ``out_dtype=torch.int32`` returns the sums."""
    if c_in is not None:
        xq, wq = xq[..., :c_in], wq[..., :c_in]
    (pt, pb), (pl, pr) = padding
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    acc = F.conv2d(x, wq.permute(0, 3, 1, 2).double(), stride=tuple(stride),
                   dilation=tuple(dilation))
    acc = torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _int8_conv_lib() -> ctypes.CDLL:
    lib = kernel_build.load('int8_conv')
    lib.vd3d_int8_conv2d_wgmma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 24 + \
        [ctypes.c_void_p]
    lib.vd3d_int8_conv2d_wgmma.restype = ctypes.c_int
    lib.vd3d_int8_quantize.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.vd3d_int8_quantize.restype = ctypes.c_int
    lib.vd3d_int8_quantize_pitched.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.vd3d_int8_quantize_pitched.restype = ctypes.c_int
    lib.vd3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vd3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _quantize_entry():
    """The quantize kernel's C entry, bound once (its argument types set)."""
    return _int8_conv_lib().vd3d_int8_quantize


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, dim: int) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'{what}: expected a CUDA tensor, got one on {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{what}: the int8 conv kernel takes {dtype}, got {t.dtype}')
    if t.dim() != dim:
        raise ValueError(f'{what}: expected {dim} dimensions, got shape {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{what}: expected a contiguous tensor; strides {t.stride()}')


def check_kernel_layout(xq: torch.Tensor, c_in: int) -> None:
    """What the kernel takes beyond dtypes and shapes: a channel pitch that
    is a multiple of 16 and at least 32 (:func:`quantize_act` with
    ``pitch=channel_pitch(c)`` writes one) and bases on 16-byte boundaries
    (the allocator's; a slice off them is refused, not copied)."""
    pitch = xq.shape[-1]
    if pitch % 16 or pitch < 32:
        raise ValueError(f'int8_conv2d: a channel pitch of {pitch} bytes for {c_in} channels; '
                         f'the kernel takes a multiple of 16, at least 32 '
                         f'(channel_pitch({c_in}) = {channel_pitch(c_in)})')
    if xq.data_ptr() % 16:
        raise ValueError('int8_conv2d: the input starts off a 16-byte boundary (a slice?); '
                         'the TMA unit takes aligned bases')


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1),
                padding: Padding = ((0, 0), (0, 0)), dilation=(1, 1),
                scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.int32, c_in: Optional[int] = None) -> torch.Tensor:
    """int8 conv: ``xq`` [B, H, W, pitch] s8, ``wq`` [C_out, kh, kw, pitch]
    s8, ``c_in`` of each pitch used (default: all) -> [B, Ho, Wo, C_out] in
    ``out_dtype``: int32 (the raw sums), float32 or bfloat16 (``acc * scale
    (+ bias)``, ``scale`` and ``bias`` f32 [C_out]). The CUDA kernel on the
    card (:func:`check_kernel_layout`); the plain version for CPU
    tensors."""
    stride, dilation = tuple(stride), tuple(dilation)
    if out_dtype not in _EPILOGUE:
        raise TypeError(f'int8_conv2d: out_dtype {out_dtype} is not one of {sorted(map(str, _EPILOGUE))}')
    if (out_dtype == torch.int32) != (scale is None):
        raise ValueError('int8_conv2d: a scale goes with a float output, none with int32')
    pitch = xq.shape[-1]
    c = pitch if c_in is None else c_in
    if wq.shape[-1] != pitch or not 0 < c <= pitch:
        raise ValueError(f'int8_conv2d: {c} channels of an input pitch of {pitch}, weights '
                         f'pitch {wq.shape[-1]}')
    if xq.device.type == 'cpu' and wq.device.type == 'cpu':
        return int8_conv2d_plain(xq, wq, stride, padding, dilation, scale, bias, out_dtype, c_in)
    _check(xq, 'int8_conv2d(xq)', torch.int8, 4)
    _check(wq, 'int8_conv2d(wq)', torch.int8, 4)
    b, h, w, _ = xq.shape
    n, kh, kw, _ = wq.shape
    check_kernel_layout(xq, c)
    if wq.data_ptr() % 16:
        raise ValueError('int8_conv2d: the weights start off a 16-byte boundary')
    for t, what in ((scale, 'scale'), (bias, 'bias')):
        if t is not None:
            _check(t, f'int8_conv2d({what})', torch.float32, 1)
            if t.shape[0] != n:
                raise ValueError(f'int8_conv2d: {what} of {t.shape[0]} for {n} output channels')
    (pt, pb), (pl, pr) = padding
    if min(pt, pb, pl, pr) < 0 or min(stride) < 1 or min(dilation) < 1:
        raise ValueError(f'int8_conv2d: stride {stride}, padding {padding}, dilation {dilation}')
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    if ho <= 0 or wo <= 0:
        raise ValueError(f'int8_conv2d: empty output {ho}x{wo} for input {h}x{w}')
    padding = ((pt, pb), (pl, pr))
    plan = plan_int8_conv(b, h, w, c, n, kh, kw, stride, padding, dilation, pitch,
                          sms=_sm_count(xq.device))
    split = plan.split > 1
    # split K adds partial sums into zeroed s32: the output itself when raw,
    # else a buffer that a second pass scales into the output
    out = (torch.zeros if split and out_dtype == torch.int32 else torch.empty)(
        (b, ho, wo, n), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    acc = (torch.zeros((b, ho, wo, n), dtype=torch.int32, device=xq.device)
           if split and out_dtype != torch.int32 else None)
    vb, vh, vw = plan.view
    vho, vwo = output_hw(vh, vw, kh, kw, stride, padding, dilation)
    lib = _int8_conv_lib()
    with torch.cuda.device(xq.device):
        rc = lib.vd3d_int8_conv2d_wgmma(
            xq.data_ptr(), wq.data_ptr(), out.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            acc.data_ptr() if acc is not None else None,
            vb, vh, vw, c, pitch, n, kh, kw, stride[0], stride[1], pt, pl, dilation[0],
            dilation[1], vho, vwo, _EPILOGUE[out_dtype], plan.box_h, plan.box_w, plan.bk,
            plan.bn, plan.stages, plan.split, plan.steps_per_split,
            torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'int8 conv kernel launch failed: '
                           f'{lib.vd3d_cuda_error_string(rc).decode()} (cudaError {rc}); '
                           f'x {tuple(xq.shape)} w {tuple(wq.shape)} c_in {c} stride {stride} '
                           f'padding {padding} dilation {dilation} out {out_dtype}; {plan}')
    LAUNCHES['int8_conv2d_wgmma_splitk' if split else 'int8_conv2d_wgmma'] += 1
    LAUNCHES['int8_conv2d'] += 1
    return out
