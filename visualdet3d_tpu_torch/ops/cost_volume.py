"""Stereo cost-volume ops (counterpart of ``visualdet3d_tpu/ops/cost_volume.py``).

Layouts follow the JAX package: NHWC in, ``[B, H, W, D]`` out. A contiguous
``[B, H, W, D]`` tensor is, through ``.permute(0, 3, 1, 2)``, the
channels_last NCHW tensor that the next conv reads.

The correlation volume is the hand-written CUDA kernel
``csrc/correlation.cu`` (it replaces the Pallas kernels ``_corr_kernel_eyes``
and ``_corr_kernel``). Its wrappers take the plain PyTorch version only for
tensors on the CPU; a CUDA tensor launches the kernel or raises. Each
wrapper counts its launches in ``LAUNCHES``. :func:`correlation_plan` gives
the kernel's division of the work (column tiles, disparity chunks and their
halos, channel chunks), as its launcher computes it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from visualdet3d_tpu_torch.ops import kernel_build

# launches of the CUDA kernel, by wrapper; reset with reset_launch_counts()
LAUNCHES = {'correlation_volume': 0, 'correlation_volume_interleaved': 0}

_ENTRY = {torch.float32: 'vd3d_correlation_f32', torch.bfloat16: 'vd3d_correlation_bf16'}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# Correlation (PSMCosine) volume: cost[b,h,w,d] = mean_c l[b,h,w,c]*r[b,h,w-d,c]
# ---------------------------------------------------------------------------

def correlation_volume_plain(left: torch.Tensor, right: torch.Tensor,
                             num_disp: int) -> torch.Tensor:
    """Plain PyTorch version: left/right [B, H, W, C] -> [B, H, W, D].

    The semantics of ``correlation_volume_xla``: entries with w < d are
    zero, including every column when d >= W. Computed in f32 from the
    inputs, returned in the input dtype (the kernel's accumulation rule).
    """
    b, h, w, _ = left.shape
    lf, rf = left.float(), right.float()
    out = torch.zeros((b, h, w, num_disp), dtype=torch.float32, device=left.device)
    for d in range(min(num_disp, w)):
        out[:, :, d:, d] = (lf[:, :, d:] * rf[:, :, :w - d]).mean(-1)
    return out.to(left.dtype)


CORR_TILE_W = 64       # output columns of a work item (4 warps of 16)
CORR_MAX_DISP = 28     # disparities of a work item
CORR_MAX_HALO = 32     # right columns staged left of a tile, at most (bf16 at 28 disparities)
CORR_ROW_BYTES = 128   # channel bytes of a row in one shared-memory stage
CORR_STAGES = 2
CORR_THREADS = 128


def correlation_halo(dc: int, dtype: torch.dtype) -> int:
    """Right-tile columns the kernel stages left of a tile for a chunk of
    ``dc`` disparities: f32, 4 x (diagonal 4x4 blocks - 1), the blocks
    ``ceil((dc - 1) / 4) + 1``; bf16, 8 x (n8 tiles - 16 / 8), the n8 tiles
    of a 16-column warp ``ceil((dc + 15) / 8)``."""
    if dtype == torch.float32:
        return 4 * (-(-(dc - 1) // 4))
    return 8 * (-(-(dc + 15) // 8)) - 16


def correlation_plan(w: int, c: int, num_disp: int, dtype: torch.dtype) -> Dict:
    """How ``csrc/correlation.cu`` divides one (pair, row) of the volume:
    ``tiles`` of ``CORR_TILE_W`` columns (the last one ragged), balanced
    ``d_chunks`` ``(d0, dc, halo)`` of at most ``CORR_MAX_DISP`` disparities,
    none empty, each with the halo of right columns it stages, and
    ``c_chunk`` channels a stage (``CORR_ROW_BYTES`` of the dtype), ``n_cc``
    stages an item. ``vec``: whether C allows the 16-byte copies (the
    launcher also asks for 16-byte aligned bases). ``smem``: a block's
    shared memory (``CORR_STAGES`` stages and each warp's band)."""
    isz = torch.empty((), dtype=dtype).element_size()
    n = -(-num_disp // CORR_MAX_DISP)
    dchunk = -(-num_disp // n)
    d_chunks: List[Tuple[int, int, int]] = []
    for d0 in range(0, num_disp, dchunk):
        dc = min(dchunk, num_disp - d0)
        d_chunks.append((d0, dc, correlation_halo(dc, dtype)))
    c_chunk = CORR_ROW_BYTES // isz
    tiles = [(w0, min(CORR_TILE_W, w - w0)) for w0 in range(0, w, CORR_TILE_W)]
    smem = (CORR_STAGES * (2 * CORR_TILE_W + CORR_MAX_HALO) * CORR_ROW_BYTES
            + CORR_THREADS // 32 * 16 * CORR_MAX_DISP * 4)
    return dict(tiles=tiles, d_chunks=d_chunks, c_chunk=c_chunk,
                n_cc=-(-c * isz // CORR_ROW_BYTES), vec=c % (16 // isz) == 0, smem=smem)


@functools.lru_cache(maxsize=None)
def _correlation_lib() -> ctypes.CDLL:
    lib = kernel_build.load('correlation')
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vd3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vd3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: expected a CUDA tensor, got one on {x.device}')
    if x.dtype not in _ENTRY:
        raise TypeError(f'{what}: the correlation kernel takes float32 or bfloat16, got {x.dtype}')
    if x.dim() != 4:
        raise ValueError(f'{what}: expected [B, H, W, C], got shape {tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{what}: expected a contiguous NHWC tensor '
                         f'(a channels_last NCHW tensor permuted to NHWC); strides {x.stride()}')
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f'{what}: the correlation kernel has no backward yet; '
                           'call it under torch.no_grad() or torch.inference_mode()')


def _launch(left_ptr: int, right_ptr: int, out: torch.Tensor, b: int, h: int, w: int,
            c: int, num_disp: int, pair_stride: int) -> None:
    """Launch on out's device and its current stream. K1 is on the batch-1
    path, so the launch takes few host steps: the stream is read raw and a
    device context is entered only when out is not on the current device."""
    fn = getattr(_correlation_lib(), _ENTRY[out.dtype])
    args = (left_ptr, right_ptr, out.data_ptr(), b, h, w, c, num_disp, pair_stride)
    index = out.get_device()
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f'correlation kernel launch failed: '
                           f'{_correlation_lib().vd3d_cuda_error_string(rc).decode()} '
                           f'(cudaError {rc}); B={b} H={h} W={w} C={c} D={num_disp} '
                           f'dtype={out.dtype}')


def correlation_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int) -> torch.Tensor:
    """PSM cosine volume from separate eyes: left/right [B, H, W, C] ->
    [B, H, W, D]. The CUDA kernel on the card (the TPU ``_corr_kernel``);
    the plain version for CPU tensors."""
    if left.device.type == 'cpu' and right.device.type == 'cpu':
        return correlation_volume_plain(left, right, num_disp)
    _check_cuda_input(left, 'correlation_volume(left)')
    _check_cuda_input(right, 'correlation_volume(right)')
    if left.shape != right.shape or left.dtype != right.dtype or left.device != right.device:
        raise ValueError(f'correlation_volume: left {tuple(left.shape)} {left.dtype} '
                         f'{left.device} and right {tuple(right.shape)} {right.dtype} '
                         f'{right.device} differ')
    b, h, w, c = left.shape
    out = torch.empty((b, h, w, num_disp), dtype=left.dtype, device=left.device)
    if out.numel():
        _launch(left.data_ptr(), right.data_ptr(), out, b, h, w, c, num_disp,
                pair_stride=h * w * c)
        LAUNCHES['correlation_volume'] += 1
    return out


def correlation_volume_interleaved(both: torch.Tensor, num_disp: int) -> torch.Tensor:
    """PSM cosine volume on the interleaved dual-eye tensor [2B, H, W, C]
    (rows 2b, 2b+1 = left, right of pair b) -> [B, H, W, D].

    The same as ``correlation_volume(both[0::2], both[1::2])``; the kernel
    (the TPU ``_corr_kernel_eyes``) reads both eyes from the one buffer, so
    no de-interleave copy is made."""
    if both.device.type == 'cpu':
        return correlation_volume_plain(both[0::2], both[1::2], num_disp)
    _check_cuda_input(both, 'correlation_volume_interleaved')
    b2, h, w, c = both.shape
    if b2 % 2:
        raise ValueError(f'correlation_volume_interleaved: odd batch {b2}')
    b = b2 // 2
    out = torch.empty((b, h, w, num_disp), dtype=both.dtype, device=both.device)
    if out.numel():
        eye = h * w * c
        _launch(both.data_ptr(), both.data_ptr() + eye * both.element_size(), out,
                b, h, w, c, num_disp, pair_stride=2 * eye)
        LAUNCHES['correlation_volume_interleaved'] += 1
    return out


# ---------------------------------------------------------------------------
# Concat cost volume (PSM CostVolume): [B, H, W, F] x2 -> [B, D, H, W, 2F]
# ---------------------------------------------------------------------------

def concat_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int) -> torch.Tensor:
    """Concatenation cost volume for 3-D conv aggregation (NDHWC): for
    disparity d the left half is left masked to w >= d and the right half is
    right shifted by d; entries with w < d are zero in both halves. Plain
    PyTorch on every device, as it is plain XLA in the JAX package."""
    b, h, w, f = left.shape
    vol = left.new_zeros((b, num_disp, h, w, 2 * f))
    for d in range(min(num_disp, w)):
        vol[:, d, :, d:, :f] = left[:, :, d:]
        vol[:, d, :, d:, f:] = right[:, :, :w - d]
    return vol
