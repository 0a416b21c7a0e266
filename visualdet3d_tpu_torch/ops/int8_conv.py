"""int8 convolution (counterpart of the s8 ``conv_general_dilated`` calls of
``visualdet3d_tpu/models/quant.py``: ``_int8_conv``, ``_conv3x3_s8`` and the
stride-2 ``_s2d_conv_int8``, whose s32 result is the direct stride-2 conv's).

Layouts: the quantized input ``xq`` is NHWC s8 (the port's channels_last
activations permuted), the weights ``wq`` are ``[C_out, kh, kw, C_in]`` s8
(an OIHW kernel in channels_last memory; the bridge turns the JAX package's
HWIO ``kernel_q`` into it), the output NHWC. ``padding`` is
``((top, bottom), (left, right))``.

The convolution is the hand-written CUDA kernel ``csrc/int8_conv.cu``, an
implicit GEMM on the int8 tensor cores with s32 accumulation and three
epilogues: the raw s32 sums, or ``acc * scale (+ bias)`` in f32, optionally
rounded to bf16 (``scale = w_scale * act_scale``, formed in f32 by the
caller as JAX forms it). It has two paths, chosen by :func:`plan_int8_conv`
from the shape alone: ``'wgmma'`` (stride 1, ``C_in % 16 == 0``, 16-byte
aligned bases: TMA loads of shifted boxes of the input and of the weights,
``wgmma`` on two consumer warpgroups, split K where few tiles meet a long
K) and ``'cp_async'`` (every other shape: an ``mma.sync`` kernel fed
by a ``cp.async`` im2col gather). The activation quantize that feeds it is
a second kernel of the same source, one pass instead of torch's five. The
wrappers take the plain PyTorch versions only for tensors on the CPU; a
CUDA tensor launches the kernel or raises. Launches are counted in
``LAUNCHES``: ``int8_conv2d`` for every conv, and one key per path.

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

# launches of the CUDA kernels: every conv, then each conv path (the wgmma
# path with and without split K, the cp.async path), and the quantize; reset
# with reset_launch_counts()
LAUNCHES = {'int8_conv2d': 0, 'int8_conv2d_wgmma': 0, 'int8_conv2d_wgmma_splitk': 0,
            'int8_conv2d_cp_async': 0, 'int8_quantize': 0}

SMS = 132  # streaming multiprocessors of an H100 SXM: the plan's default
BOX_WIDTHS = (64, 32, 16, 8)  # box widths of 64-pixel A boxes (height 64 / width)
TILE_NS = (64, 128, 256)      # output channels of a block on the wgmma path
CP_ASYNC_BM = 128             # output pixels of a block on the cp.async path
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


def quantize_act_plain(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantize_act`."""
    return torch.clamp(torch.round(x.float() * inv_scale), -127, 127).to(torch.int8)


_QUANT_DTYPES = (torch.float32, torch.bfloat16)


def quantize_act(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization of an activation: ``x`` (f32 or bf16)
    times the f32 reciprocal of its scale (never a division: ``x / a`` and
    ``x * (1/a)`` differ by an ulp at round ties and flip int8 levels),
    rounded half to even, clipped to +-127. ``inv_scale`` is a scalar or one
    value per channel of the innermost axis. The CUDA kernel on the card
    (``x`` contiguous, any base); the plain version for CPU tensors.

    The wrapper is on the int8 predict's host path (one call a quantized
    conv), so it takes few host steps: the library's entry point is bound
    once, the stream is read raw, and a device context is entered only when
    ``x`` is not on the current device. Nothing that can go stale is kept."""
    if x.device.type == 'cpu' and inv_scale.device.type == 'cpu':
        return quantize_act_plain(x, inv_scale)
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
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    n = out.numel()
    if n == 0:
        return out
    fn = _quantize_entry()
    args = (x.data_ptr(), inv_scale.data_ptr(), out.data_ptr(), n, n_inv,
            x.dtype is torch.bfloat16)
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
    path: str                # 'wgmma' or 'cp_async'
    grid: int                # blocks launched
    box_h: int = 0           # the 64-pixel A box of one consumer warpgroup
    box_w: int = 0
    bk: int = 0              # bytes of K per step: a channel chunk of one tap
    bn: int = 0              # output channels of a block
    chunks: int = 0          # channel chunks per tap
    k_steps: int = 0         # taps x chunks
    split: int = 1           # blocks sharing one output tile's K steps
    steps_per_split: int = 0
    m_tiles: int = 0         # pairs of boxes
    n_tiles: int = 0


@functools.lru_cache(maxsize=1024)
def plan_int8_conv(b: int, h: int, w: int, c: int, n: int, kh: int, kw: int,
                   stride=(1, 1), padding: Padding = ((0, 0), (0, 0)), dilation=(1, 1),
                   aligned: bool = True, sms: int = SMS,
                   split_k: Optional[bool] = None) -> Int8ConvPlan:
    """The path, tiles and split of one int8 conv, from its shape alone.

    The wgmma path takes stride 1 with ``c % 16 == 0`` (the TMA unit's
    16-byte strides), ``c >= 32`` (one k32 step of wgmma) and 16-byte
    aligned bases (``aligned``); every other shape takes the cp.async path.
    On the wgmma path a block owns two boxes of 64 output pixels, the box
    (``box_h x box_w``, a power-of-two width) that covers the output map
    with the fewest boxes (ties: the wider), and ``bn`` output channels,
    the one of :data:`TILE_NS` with the least ``tiles * (bn + 32)`` (the
    A tile is read once per N tile; ties: the wider). K runs as taps x
    channel chunks of ``bk`` = 128, 64 or 32 bytes, the largest that
    divides ``c`` (32, with a zero-filled tail, where none does). Where
    split K pays (the tiles fill at most a third of ``sms`` and K has
    :data:`SPLIT_MIN_K_STEPS` steps or more), K is split into ``split`` runs
    of ``steps_per_split`` steps, enough for the grid to reach ``sms``
    blocks or, failing that, one step per block. ``split_k`` True or False
    overrides that rule (to measure it)."""
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    if stride != (1, 1) or c % 16 or c < 32 or not aligned:
        bn = 128 if n >= 128 else 64
        return Int8ConvPlan('cp_async', math.ceil(b * ho * wo / CP_ASYNC_BM) * math.ceil(n / bn),
                            bn=bn)
    box_h, box_w = min(((64 // bw, bw) for bw in BOX_WIDTHS),
                       key=lambda hw: (math.ceil(ho / hw[0]) * math.ceil(wo / hw[1]), -hw[1]))
    m_boxes = b * math.ceil(ho / box_h) * math.ceil(wo / box_w)
    m_tiles = math.ceil(m_boxes / 2)
    bk = next((v for v in (128, 64, 32) if c % v == 0), 32)
    chunks = math.ceil(c / bk)
    bn = min(TILE_NS, key=lambda t: (math.ceil(n / t) * (t + 32), -t))
    n_tiles = math.ceil(n / bn)
    k_steps = kh * kw * chunks
    tiles = m_tiles * n_tiles
    per = k_steps
    if split_k is None:
        split_k = 3 * tiles <= sms and k_steps >= SPLIT_MIN_K_STEPS
    if tiles < sms and split_k:
        per = max(1, k_steps // math.ceil(sms / tiles))
    split = math.ceil(k_steps / per)
    return Int8ConvPlan('wgmma', tiles * split, box_h, box_w, bk, bn, chunks, k_steps, split,
                        per, m_tiles, n_tiles)


def split_k_ranges(plan: Int8ConvPlan, c: int) -> List[List[Tuple[int, int, int]]]:
    """The K slices of each split of a wgmma plan: per split, its steps as
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
                      out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plain PyTorch version: the s32 sums exactly (a float64 conv of the
    integers), then the epilogue ``acc.float() * scale``, ``+ bias``, cast to
    ``out_dtype``; ``out_dtype=torch.int32`` returns the sums."""
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
    lib.vd3d_int8_conv2d.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    lib.vd3d_int8_conv2d.restype = ctypes.c_int
    lib.vd3d_int8_conv2d_wgmma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 20 + \
        [ctypes.c_void_p]
    lib.vd3d_int8_conv2d_wgmma.restype = ctypes.c_int
    lib.vd3d_int8_quantize.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.vd3d_int8_quantize.restype = ctypes.c_int
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


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1),
                padding: Padding = ((0, 0), (0, 0)), dilation=(1, 1),
                scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """int8 conv: ``xq`` [B, H, W, C_in] s8, ``wq`` [C_out, kh, kw, C_in] s8
    -> [B, Ho, Wo, C_out] in ``out_dtype``: int32 (the raw sums), float32 or
    bfloat16 (``acc * scale (+ bias)``, ``scale`` and ``bias`` f32
    [C_out]). The CUDA kernel on the card; the plain version for CPU
    tensors."""
    stride, dilation = tuple(stride), tuple(dilation)
    if out_dtype not in _EPILOGUE:
        raise TypeError(f'int8_conv2d: out_dtype {out_dtype} is not one of {sorted(map(str, _EPILOGUE))}')
    if (out_dtype == torch.int32) != (scale is None):
        raise ValueError('int8_conv2d: a scale goes with a float output, none with int32')
    if xq.device.type == 'cpu' and wq.device.type == 'cpu':
        return int8_conv2d_plain(xq, wq, stride, padding, dilation, scale, bias, out_dtype)
    _check(xq, 'int8_conv2d(xq)', torch.int8, 4)
    _check(wq, 'int8_conv2d(wq)', torch.int8, 4)
    b, h, w, c = xq.shape
    n, kh, kw, c_w = wq.shape
    if c_w != c:
        raise ValueError(f'int8_conv2d: input has {c} channels, weights take {c_w}')
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
    plan = plan_int8_conv(b, h, w, c, n, kh, kw, stride, ((pt, pb), (pl, pr)), dilation,
                          aligned=(xq.data_ptr() | wq.data_ptr()) % 16 == 0,
                          sms=_sm_count(xq.device))
    split = plan.path == 'wgmma' and plan.split > 1
    # split K adds partial sums into zeroed s32: the output itself when raw,
    # else a buffer that a second pass scales into the output
    out = (torch.zeros if split and out_dtype == torch.int32 else torch.empty)(
        (b, ho, wo, n), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    acc = (torch.zeros((b, ho, wo, n), dtype=torch.int32, device=xq.device)
           if split and out_dtype != torch.int32 else None)
    lib = _int8_conv_lib()
    pointers = (xq.data_ptr(), wq.data_ptr(), out.data_ptr(),
                scale.data_ptr() if scale is not None else None,
                bias.data_ptr() if bias is not None else None)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        if plan.path == 'wgmma':
            rc = lib.vd3d_int8_conv2d_wgmma(
                *pointers, acc.data_ptr() if acc is not None else None,
                b, h, w, c, n, kh, kw, pt, pl, dilation[0], dilation[1], ho, wo,
                _EPILOGUE[out_dtype], plan.box_h, plan.box_w, plan.bk, plan.bn, plan.split,
                plan.steps_per_split, stream)
        else:
            rc = lib.vd3d_int8_conv2d(
                *pointers, b, h, w, c, n, kh, kw, stride[0], stride[1], pt, pl, dilation[0],
                dilation[1], ho, wo, _EPILOGUE[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f'int8 conv kernel launch failed ({plan.path} path): '
                           f'{lib.vd3d_cuda_error_string(rc).decode()} (cudaError {rc}); '
                           f'x {tuple(xq.shape)} w {tuple(wq.shape)} stride {stride} '
                           f'padding {padding} dilation {dilation} out {out_dtype}; {plan}')
    LAUNCHES[f'int8_conv2d_{plan.path}{"_splitk" if split else ""}'] += 1
    LAUNCHES['int8_conv2d'] += 1
    return out
