"""Stereo cost-volume ops (counterpart of ``visualdet3d_tpu/ops/cost_volume.py``).

Layouts follow the JAX package: NHWC in, ``[B, H, W, D]`` out. A contiguous
``[B, H, W, D]`` tensor is, through ``.permute(0, 3, 1, 2)``, the
channels_last NCHW tensor that the next conv reads.

The correlation volume is the hand-written CUDA kernel
``csrc/correlation.cu`` (it replaces the Pallas kernels ``_corr_kernel_eyes``
and ``_corr_kernel``). Its wrappers take the plain PyTorch version only for
tensors on the CPU; a CUDA tensor launches the kernel or raises. Each
wrapper counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools

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
    lib = _correlation_lib()
    fn = getattr(lib, _ENTRY[out.dtype])
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(left_ptr, right_ptr, out.data_ptr(), b, h, w, c, num_disp, pair_stride, stream)
    if rc != 0:
        raise RuntimeError(f'correlation kernel launch failed: '
                           f'{lib.vd3d_cuda_error_string(rc).decode()} (cudaError {rc}); '
                           f'B={b} H={h} W={w} C={c} D={num_disp} dtype={out.dtype}')


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
