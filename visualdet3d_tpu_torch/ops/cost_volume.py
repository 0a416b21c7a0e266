"""Stereo cost-volume ops (counterpart of ``visualdet3d_tpu/ops/cost_volume.py``).

Layouts follow the JAX package: NHWC in, ``[B, H, W, D]`` out. A contiguous
``[B, H, W, D]`` tensor is, through ``.permute(0, 3, 1, 2)``, the
channels_last NCHW tensor that the next conv reads.

The correlation volume is the hand-written CUDA kernel
``csrc/correlation.cu`` (it replaces the Pallas kernels ``_corr_kernel_eyes``
and ``_corr_kernel``), and so is its backward (which replaces the XLA vjp
the JAX package differentiates them with): both are wired into autograd by
a ``torch.autograd.Function``, so the volumes are differentiable in both
eyes. The wrappers take the plain PyTorch versions only for tensors on the
CPU; a CUDA tensor launches the kernel or raises. Each wrapper counts its
launches in ``LAUNCHES``. :func:`correlation_plan` and
:func:`correlation_bwd_plan` give the kernels' division of the work (column
tiles, disparity chunks and their halos, channel chunks), as their
launchers compute it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from visualdet3d_tpu_torch.ops import kernel_build

# launches of the CUDA kernels, by wrapper; reset with reset_launch_counts()
LAUNCHES = {'correlation_volume': 0, 'correlation_volume_interleaved': 0,
            'correlation_backward': 0, 'correlation_backward_interleaved': 0}

_ENTRY = {torch.float32: 'vd3d_correlation_f32', torch.bfloat16: 'vd3d_correlation_bf16'}
_BWD_ENTRY = {torch.float32: 'vd3d_correlation_backward_f32',
              torch.bfloat16: 'vd3d_correlation_backward_bf16'}


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
    zero, including every column when d >= W. Computed in f32 (f64 for f64
    inputs) from the inputs, returned in the input dtype (the kernel's
    accumulation rule).
    """
    b, h, w, _ = left.shape
    acc = _acc_dtype(left.dtype)
    lf, rf = left.to(acc), right.to(acc)
    out = torch.zeros((b, h, w, num_disp), dtype=acc, device=left.device)
    for d in range(min(num_disp, w)):
        out[:, :, d:, d] = (lf[:, :, d:] * rf[:, :, :w - d]).mean(-1)
    return out.to(left.dtype)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def correlation_backward_plain_eyes(left: torch.Tensor, right: torch.Tensor,
                                    g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of the volume: left/right [B, H, W, C] and the
    volume's gradient g [B, H, W, D] -> (dL, dR), each [B, H, W, C]:

        dL[w]  = (1/C) sum_d g[w, d]     R[w - d]
        dR[w'] = (1/C) sum_d g[w' + d, d] L[w' + d]

    both sums over w - d >= 0 only (the forward's zeros take no gradient).
    Accumulated in f32 (f64 for f64 inputs), each rounded once to its
    input's dtype."""
    b, h, w, c = left.shape
    acc = _acc_dtype(left.dtype)
    lf, rf, gf = left.to(acc), right.to(acc), g.to(acc)
    dl = torch.zeros((b, h, w, c), dtype=acc, device=left.device)
    dr = torch.zeros_like(dl)
    for d in range(min(g.shape[-1], w)):
        gd = gf[:, :, d:, d:d + 1]
        dl[:, :, d:] += gd * rf[:, :, :w - d]
        dr[:, :, :w - d] += gd * lf[:, :, d:]
    return (dl / c).to(left.dtype), (dr / c).to(right.dtype)


def correlation_backward_plain(both: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain backward on the interleaved dual-eye tensor [2B, H, W, C]: the
    gradient [2B, H, W, C], dL in rows 2b and dR in rows 2b + 1."""
    dl, dr = correlation_backward_plain_eyes(both[0::2], both[1::2], g)
    return torch.stack([dl, dr], dim=1).flatten(0, 1)


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


CORR_BWD_MAX_DISP = 32   # disparities the backward kernel takes
CORR_BWD_GPAD = 3        # zero columns on each side of a staged g row


def correlation_bwd_plan(w: int, c: int, num_disp: int, dtype: torch.dtype) -> Dict:
    """How the backward kernel of ``csrc/correlation.cu`` divides one
    (pair, row): ``tiles`` of ``CORR_TILE_W`` columns (the last one ragged),
    each staging ``rows`` = 64 + D - 1 rows of L (the halo to the right),
    of R (the halo to the left) and of g; g's rows padded with
    ``CORR_BWD_GPAD`` zero columns on each side, ``gstride`` floats a row (4
    column groups of a warp on 4 distinct banks); ``c_chunk`` channels a
    stage, ``n_cc`` stages an item; ``vec``: whether C and W * D allow the
    16-byte copies (the launcher also asks for 16-byte aligned bases);
    ``smem``: a block's shared memory (two stages and the f32 g rows)."""
    if not 0 < num_disp <= CORR_BWD_MAX_DISP:
        raise ValueError(f'the correlation backward kernel takes 1 to {CORR_BWD_MAX_DISP} '
                         f'disparities, got {num_disp}')
    isz = torch.empty((), dtype=dtype).element_size()
    rows = CORR_TILE_W + num_disp - 1
    gstride = num_disp + 2 * CORR_BWD_GPAD
    gstride += gstride % 4 == 0
    stage = 2 * rows * CORR_ROW_BYTES + -(-rows * num_disp * isz // 16) * 16
    vec = 16 // isz
    return dict(tiles=[(w0, min(CORR_TILE_W, w - w0)) for w0 in range(0, w, CORR_TILE_W)],
                rows=rows, gstride=gstride, c_chunk=CORR_ROW_BYTES // isz,
                n_cc=-(-c * isz // CORR_ROW_BYTES), vec=c % vec == 0 and w * num_disp % vec == 0,
                smem=CORR_STAGES * stage + rows * gstride * 4)


@functools.lru_cache(maxsize=None)
def _correlation_lib() -> ctypes.CDLL:
    lib = kernel_build.load('correlation')
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _BWD_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                                                    ctypes.c_void_p]
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


def _launch(left_ptr: int, right_ptr: int, out: torch.Tensor, b: int, h: int, w: int,
            c: int, num_disp: int, pair_stride: int) -> None:
    """Launch K1 on out's device and its current stream."""
    _call(_ENTRY[out.dtype], out,
          (left_ptr, right_ptr, out.data_ptr(), b, h, w, c, num_disp, pair_stride),
          f'B={b} H={h} W={w} C={c} D={num_disp}')


def _call(entry: str, out: torch.Tensor, args: tuple, shape: str) -> None:
    """Call ``entry`` of the library on out's device and its current stream.
    K1 is on the batch-1 path, so the launch takes few host steps: the
    stream is read raw and a device context is entered only when out is not
    on the current device."""
    fn = getattr(_correlation_lib(), entry)
    index = out.get_device()
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f'{entry} launch failed: '
                           f'{_correlation_lib().vd3d_cuda_error_string(rc).decode()} '
                           f'(cudaError {rc}); {shape} dtype={out.dtype}')


def _check_pair(left: torch.Tensor, right: torch.Tensor, what: str) -> None:
    if left.shape != right.shape or left.dtype != right.dtype or left.device != right.device:
        raise ValueError(f'{what}: left {tuple(left.shape)} {left.dtype} {left.device} and '
                         f'right {tuple(right.shape)} {right.dtype} {right.device} differ')


def _volume_eyes(left: torch.Tensor, right: torch.Tensor, num_disp: int) -> torch.Tensor:
    if left.device.type == 'cpu' and right.device.type == 'cpu':
        return correlation_volume_plain(left, right, num_disp)
    _check_cuda_input(left, 'correlation_volume(left)')
    _check_cuda_input(right, 'correlation_volume(right)')
    _check_pair(left, right, 'correlation_volume')
    b, h, w, c = left.shape
    out = torch.empty((b, h, w, num_disp), dtype=left.dtype, device=left.device)
    if out.numel():
        _launch(left.data_ptr(), right.data_ptr(), out, b, h, w, c, num_disp,
                pair_stride=h * w * c)
        LAUNCHES['correlation_volume'] += 1
    return out


def _volume_interleaved(both: torch.Tensor, num_disp: int) -> torch.Tensor:
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


def _check_volume_grad(g: torch.Tensor, b: int, h: int, w: int, x: torch.Tensor,
                       what: str) -> None:
    _check_cuda_input(g, f'{what}(g)')
    if g.dtype != x.dtype or g.device != x.device or tuple(g.shape[:3]) != (b, h, w):
        raise ValueError(f'{what}: gradient {tuple(g.shape)} {g.dtype} {g.device} does not '
                         f'match the volume of {tuple(x.shape)} {x.dtype} {x.device}')
    if not 0 < g.shape[3] <= CORR_BWD_MAX_DISP:
        raise ValueError(f'{what}: the backward kernel takes 1 to {CORR_BWD_MAX_DISP} '
                         f'disparities, got {g.shape[3]}')


def _launch_backward(left_ptr: int, right_ptr: int, g: torch.Tensor, dleft_ptr: int,
                     dright_ptr: int, out: torch.Tensor, b: int, h: int, w: int, c: int,
                     pair_stride: int) -> None:
    num_disp = g.shape[3]
    _call(_BWD_ENTRY[out.dtype], out,
          (left_ptr, right_ptr, g.data_ptr(), dleft_ptr, dright_ptr, b, h, w, c, num_disp,
           pair_stride), f'B={b} H={h} W={w} C={c} D={num_disp}')


def correlation_backward(left: torch.Tensor, right: torch.Tensor,
                         g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The volume's backward for separate eyes: left/right [B, H, W, C] and
    the contiguous volume gradient g [B, H, W, D] -> (dL, dR). The CUDA
    kernel on the card; the plain version for CPU tensors."""
    if left.device.type == 'cpu' and right.device.type == 'cpu' and g.device.type == 'cpu':
        return correlation_backward_plain_eyes(left, right, g)
    _check_cuda_input(left, 'correlation_backward(left)')
    _check_cuda_input(right, 'correlation_backward(right)')
    _check_pair(left, right, 'correlation_backward')
    b, h, w, c = left.shape
    _check_volume_grad(g, b, h, w, left, 'correlation_backward')
    dl, dr = torch.empty_like(left), torch.empty_like(right)
    if dl.numel():
        _launch_backward(left.data_ptr(), right.data_ptr(), g, dl.data_ptr(), dr.data_ptr(), dl,
                         b, h, w, c, pair_stride=h * w * c)
        LAUNCHES['correlation_backward'] += 1
    return dl, dr


def correlation_backward_interleaved(both: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The volume's backward on the interleaved dual-eye tensor [2B, H, W, C]
    and the contiguous volume gradient g [B, H, W, D] -> the gradient
    [2B, H, W, C] (dL in rows 2b, dR in rows 2b + 1: no de-interleave
    copy), in both's dtype. The CUDA kernel on the card; the plain version
    for CPU tensors."""
    if both.device.type == 'cpu' and g.device.type == 'cpu':
        return correlation_backward_plain(both, g)
    _check_cuda_input(both, 'correlation_backward_interleaved')
    b2, h, w, c = both.shape
    if b2 % 2:
        raise ValueError(f'correlation_backward_interleaved: odd batch {b2}')
    _check_volume_grad(g, b2 // 2, h, w, both, 'correlation_backward_interleaved')
    out = torch.empty_like(both)
    if out.numel():
        eye = h * w * c * both.element_size()
        _launch_backward(both.data_ptr(), both.data_ptr() + eye, g, out.data_ptr(),
                         out.data_ptr() + eye, out, b2 // 2, h, w, c, pair_stride=2 * h * w * c)
        LAUNCHES['correlation_backward_interleaved'] += 1
    return out


class _CorrelationEyes(torch.autograd.Function):
    """The separate-eyes volume: K1's kernel forward, the backward kernel."""

    @staticmethod
    def forward(ctx, left, right, num_disp):
        ctx.save_for_backward(left, right)
        return _volume_eyes(left, right, num_disp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        left, right = ctx.saved_tensors
        # autograd may hand a strided view (the volume is read as a
        # channels_last NCHW tensor downstream): the kernel reads it dense
        dl, dr = correlation_backward(left, right, g.contiguous())
        return dl, dr, None


class _CorrelationInterleaved(torch.autograd.Function):
    """The interleaved volume: K1's kernel forward, the backward kernel."""

    @staticmethod
    def forward(ctx, both, num_disp):
        ctx.save_for_backward(both)
        return _volume_interleaved(both, num_disp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (both,) = ctx.saved_tensors
        return correlation_backward_interleaved(both, g.contiguous()), None


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def correlation_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int) -> torch.Tensor:
    """PSM cosine volume from separate eyes: left/right [B, H, W, C] ->
    [B, H, W, D], differentiable in both eyes. The CUDA kernels on the card
    (the TPU ``_corr_kernel``; the backward kernel); the plain versions for
    CPU tensors."""
    if _needs_grad(left, right):
        return _CorrelationEyes.apply(left, right, num_disp)
    return _volume_eyes(left, right, num_disp)


def correlation_volume_interleaved(both: torch.Tensor, num_disp: int) -> torch.Tensor:
    """PSM cosine volume on the interleaved dual-eye tensor [2B, H, W, C]
    (rows 2b, 2b+1 = left, right of pair b) -> [B, H, W, D], differentiable.

    The same as ``correlation_volume(both[0::2], both[1::2])``; the kernels
    (the TPU ``_corr_kernel_eyes``; the backward kernel) read both eyes from
    the one buffer and write both eyes' gradients into one, so no
    de-interleave copy is made."""
    if _needs_grad(both):
        return _CorrelationInterleaved.apply(both, num_disp)
    return _volume_interleaved(both, num_disp)


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
