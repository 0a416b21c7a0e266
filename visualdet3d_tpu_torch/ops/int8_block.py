"""Fused int8 identity BasicBlock (counterpart of
``visualdet3d_tpu/ops/int8_block.py``, ``int8_basic_block_fused``).

For the quantized input ``xq`` [B, H, W, 64] s8 (NHWC) of a stride-1
BasicBlock whose two 3x3 convs are quantized, with per-channel f32
``params`` [6, 64] (rows: ``w1_scale*act1*bn1_scale``, ``bn1_shift``,
``1/act2``, ``w2_scale*act2*bn2_scale``, ``bn2_shift``, ``act1``):

    h   = relu(conv3x3(xq, w1) * p0 + p1) * p2,  hq = clip(round(h), +-127)
    out = relu(conv3x3(hq, w2) * p3 + p4 + xq * p5)

The residual is the dequantized int8 input ``xq * act1``, as in the TPU
kernel. The block is the hand-written CUDA kernel ``csrc/int8_block.cu``
(it replaces the Pallas kernel ``_block_kernel``); the input's quantize
is a pass of its own (``int8_conv.quantize_act``), as JAX computes it
outside its kernel. The wrapper takes the plain PyTorch version
only for tensors on the CPU; a CUDA tensor launches the kernel or raises.
Launches are counted in ``LAUNCHES``. :func:`block_plan` mirrors the
kernel's tiles, its flat-row layout and its grid.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from visualdet3d_tpu_torch.ops import kernel_build
from visualdet3d_tpu_torch.ops.int8_conv import _sm_count, int8_conv2d_plain

CHANNELS = 64  # the kernel's channel count
LAUNCHES = {'int8_basic_block': 0}

SMS = 132                 # streaming multiprocessors of an H100 SXM: the plan's default
TILE_H, TILE_W = 6, 64    # the kernel's output tile (TH, TW)
PITCH = TILE_W + 4        # row pitch of the staged input and of hq, pixels (P)
CONSUMER_WARPGROUPS = 3


class BlockPlan(NamedTuple):
    """How ``csrc/int8_block.cu`` runs one shape (see :func:`block_plan`)."""
    tile_h: int
    tile_w: int
    pitch: int           # P: tap (ky, kx) of flat position q is staged position q + ky*P + kx
    tiles_y: int
    tiles_x: int
    tiles: int           # B * tiles_y * tiles_x, walked by the persistent blocks in turn
    grid: int            # persistent blocks: the SMs, at most the tiles
    units1: int          # conv1's 64-position units over the flat (TH + 2) x P region
    units2: int          # conv2's units: one an output row
    x_positions: int     # positions of one staged channel plane
    h_positions: int     # positions of one hq channel plane
    smem: int            # dynamic shared memory of a block, bytes
    threads: int


@functools.lru_cache(maxsize=1024)
def block_plan(b: int, h: int, w: int, sms: int = SMS) -> BlockPlan:
    """The fused block kernel's tiles, layout and grid for a [b, h, w, 64]
    input, mirroring the constants and the launcher of
    ``csrc/int8_block.cu``: output tiles of ``TILE_H`` rows x ``TILE_W``
    pixels; the staged input (2-pixel halo, ``TILE_H + 4`` rows) and hq
    (1-pixel halo) in 16-byte channel planes with the row pitch ``PITCH``;
    conv1 in 64-position units over the flat region, conv2 one unit an
    output row; both weight sets, a 2-stage ring of staged tiles, hq, an
    output staging buffer of 64 x 128 bytes a consumer warpgroup, the
    parameters and four mbarriers, plus 128 bytes to align the base."""
    tiles_y, tiles_x = math.ceil(h / TILE_H), math.ceil(w / TILE_W)
    tiles = b * tiles_y * tiles_x
    units1 = math.ceil((TILE_H + 2) * PITCH / 64)
    x_positions = (64 * units1 + 2 * PITCH + 2 + 7) // 8 * 8
    h_positions = 64 * units1
    c = CHANNELS
    smem = (2 * 9 * c * c + 2 * 4 * x_positions * 16 + 4 * h_positions * 16
            + CONSUMER_WARPGROUPS * 64 * 128 + 6 * c * 4 + 4 * 8 + 128)
    return BlockPlan(TILE_H, TILE_W, PITCH, tiles_y, tiles_x, tiles, min(tiles, sms), units1,
                     TILE_H, x_positions, h_positions, smem, 128 * CONSUMER_WARPGROUPS + 32)

_PAD1 = ((1, 1), (1, 1))


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def block_params(e1: dict, e2: dict, bn1_scale, bn1_shift, bn2_scale, bn2_shift) -> torch.Tensor:
    """The kernel's [6, C] f32 parameter rows from the two conv entries
    (``w_scale``, ``act_scale``) and the block's BatchNorm affines, formed as
    the JAX wrapper forms them."""
    a1, a2 = e1['act_scale'].float(), e2['act_scale'].float()
    c = e1['w_scale'].shape[0]
    return torch.stack([
        e1['w_scale'] * a1 * bn1_scale,
        bn1_shift.float(),
        torch.broadcast_to(1.0 / a2, (c,)),
        e2['w_scale'] * a2 * bn2_scale,
        bn2_shift.float(),
        torch.broadcast_to(a1, (c,)),
    ]).float().contiguous()


def int8_basic_block_plain(xq: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                           params: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version (``_ref_block_dequant_residual`` of the JAX
    package's tests): exact s32 sums, f32 epilogues in the kernel's order."""
    p = params
    h = int8_conv2d_plain(xq, w1, padding=_PAD1).float() * p[0] + p[1]
    hq = torch.clamp(torch.round(torch.clamp_min(h, 0.0) * p[2]), -127, 127).to(torch.int8)
    y = int8_conv2d_plain(hq, w2, padding=_PAD1).float() * p[3] + p[4]
    return torch.clamp_min(y + xq.float() * p[5], 0.0).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _int8_block_lib() -> ctypes.CDLL:
    lib = kernel_build.load('int8_block')
    lib.vd3d_int8_basic_block.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.vd3d_int8_basic_block.restype = ctypes.c_int
    lib.vd3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vd3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'{what}: expected a CUDA tensor, got one on {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{what}: the fused int8 block kernel takes {dtype}, got {t.dtype}')
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f'{what}: expected shape {shape}, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{what}: expected a contiguous tensor; strides {t.stride()}')


def int8_basic_block(xq: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, params: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused block: ``xq`` [B, H, W, 64] s8, ``w1``/``w2`` [64, 3, 3, 64] s8,
    ``params`` [6, 64] f32 -> [B, H, W, 64] in ``out_dtype`` (float32 or
    bfloat16). The CUDA kernel on the card; the plain version for CPU
    tensors."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'int8_basic_block: out_dtype {out_dtype} is not float32 or bfloat16')
    if all(t.device.type == 'cpu' for t in (xq, w1, w2, params)):
        return int8_basic_block_plain(xq, w1, w2, params, out_dtype)
    c = CHANNELS
    _check(xq, 'int8_basic_block(xq)', torch.int8, (None, None, None, c))
    _check(w1, 'int8_basic_block(w1)', torch.int8, (c, 3, 3, c))
    _check(w2, 'int8_basic_block(w2)', torch.int8, (c, 3, 3, c))
    _check(params, 'int8_basic_block(params)', torch.float32, (6, c))
    b, h, w, _ = xq.shape
    index = xq.get_device()
    if any(t.get_device() != index for t in (w1, w2, params)):
        raise ValueError(f'int8_basic_block: inputs on {xq.device}, {w1.device}, {w2.device}, '
                         f'{params.device}')
    out = torch.empty((b, h, w, c), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    lib = _int8_block_lib()
    plan = block_plan(b, h, w, _sm_count(index))
    args = (xq.data_ptr(), w1.data_ptr(), w2.data_ptr(), params.data_ptr(), out.data_ptr(),
            b, h, w, out_dtype is torch.bfloat16, plan.grid)
    if index == torch.cuda.current_device():
        rc = lib.vd3d_int8_basic_block(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = lib.vd3d_int8_basic_block(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f'fused int8 block kernel launch failed: '
                           f'{lib.vd3d_cuda_error_string(rc).decode()} (cudaError {rc}); '
                           f'xq {tuple(xq.shape)} out {out_dtype}')
    LAUNCHES['int8_basic_block'] += 1
    return out
