"""Deformable convolution v1/v2 (counterpart of ``visualdet3d_tpu/ops/deform_conv.py``).

Layouts follow the JAX package: NHWC ``x`` and output, offsets
``[B, Ho, Wo, 2K]`` with (dy, dx) of tap k at channels (2k, 2k+1) and taps
row-major, mask ``[B, Ho, Wo, K]`` (post-sigmoid), weight HWIO.

The forward is the hand-written CUDA kernel ``csrc/deform_conv.cu`` (it
replaces the Pallas kernels ``_lerp_matmul_kernel`` (bf16) and
``_lerp_matmul_f32_kernel`` (f32)). The wrapper takes the plain PyTorch
version only for tensors on the CPU; a CUDA tensor launches the kernel or
raises. Launches are counted in ``LAUNCHES``.

Rounding points (those of the JAX packed paths, which the kernel keeps):
sample coordinates in f32 from the offsets cast to f32; the fractional
parts ``fx``, ``fy`` rounded to the input dtype; the four lerp weights
``1-fx``, ``fx``, ``(1-fy)*mask``, ``fy*mask`` formed in the input dtype;
the lerp in f32 (the y lerp per corner column, then the x lerp, each
product and sum rounded on its own: no fused multiply-add); in bf16 the
sampled value rounded to bf16 before the tap product; f32 accumulation;
the output rounded to the input dtype, then ``+ bias`` in that dtype. A
corner outside the image contributes 0 (the CUDA ``dmcn_im2col_bilinear``
rule).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from visualdet3d_tpu_torch.ops import kernel_build

# launches of the CUDA kernel; reset with reset_launch_counts()
LAUNCHES = {'modulated_deform_conv': 0}

_ENTRY = {torch.float32: 'vd3d_modulated_deform_conv_f32',
          torch.bfloat16: 'vd3d_modulated_deform_conv_bf16'}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def output_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int,
              dilation: int) -> Tuple[int, int]:
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    return ho, wo


def _tap_coords(offset: torch.Tensor, ho: int, wo: int, kh: int, kw: int, stride: int,
                padding: int, dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 sample coordinates [B, Ho, Wo, K] (py, px) of every tap."""
    f32, dev = torch.float32, offset.device
    base_y = torch.arange(ho, dtype=f32, device=dev) * stride - padding
    base_x = torch.arange(wo, dtype=f32, device=dev) * stride - padding
    tap_y = (torch.arange(kh, dtype=f32, device=dev) * dilation).repeat_interleave(kw)
    tap_x = (torch.arange(kw, dtype=f32, device=dev) * dilation).repeat(kh)
    offset = offset.float()
    py = base_y[None, :, None, None] + tap_y + offset[..., 0::2]
    px = base_x[None, None, :, None] + tap_x + offset[..., 1::2]
    return py, px


def modulated_deform_conv_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                                stride: int = 1, padding: int = 1,
                                dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward with the kernel's rounding points (see
    the module docstring). x [B, H, W, C_in], offset [B, Ho, Wo, 2K],
    mask [B, Ho, Wo, K], weight [kh, kw, C_in, C_out], bias [C_out] ->
    [B, Ho, Wo, C_out] in x's dtype."""
    b, h, w, c_in = x.shape
    kh, kw, _, c_out = weight.shape
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    dtype = x.dtype
    py, px = _tap_coords(offset, ho, wo, kh, kw, stride, padding, dilation)
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = (py - y0).to(dtype), (px - x0).to(dtype)
    mask = mask.to(dtype)
    # lerp weights in the input dtype, then f32 for the lerp
    wx0, wx1 = (1 - fx).float(), fx.float()
    wy0, wy1 = ((1 - fy) * mask).float(), (fy * mask).float()
    # clamp before the integer cast (|offset| may be huge); [-2, H] keeps
    # every corner's inside/outside verdict
    y0 = y0.clamp(-2, h).long()
    x0 = x0.clamp(-2, w).long()

    flat = x.reshape(b, h * w, c_in).float()
    wk = weight.reshape(kh * kw, c_in, c_out).float()
    acc = torch.zeros((b, ho * wo, c_out), dtype=torch.float32, device=x.device)
    for k in range(kh * kw):
        def corner(yy, xx):
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, -1)
            v = flat.gather(1, idx[..., None].expand(-1, -1, c_in))
            return torch.where(inside.reshape(b, -1, 1), v, 0.0)
        yk, xk = y0[..., k], x0[..., k]
        v00, v01 = corner(yk, xk), corner(yk, xk + 1)
        v10, v11 = corner(yk + 1, xk), corner(yk + 1, xk + 1)
        a0, a1 = wy0[..., k].reshape(b, -1, 1), wy1[..., k].reshape(b, -1, 1)
        vx0 = v00 * a0 + v10 * a1
        vx1 = v01 * a0 + v11 * a1
        sampled = vx0 * wx0[..., k].reshape(b, -1, 1) + vx1 * wx1[..., k].reshape(b, -1, 1)
        # bf16: the sampled value is rounded before the tap product; the
        # product of two bf16 values is exact in f32
        sampled = sampled.to(dtype).float()
        acc += sampled @ wk[k]
    out = acc.to(dtype).reshape(b, ho, wo, c_out)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


@functools.lru_cache(maxsize=None)
def _deform_conv_lib() -> ctypes.CDLL:
    lib = kernel_build.load('deform_conv')
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.vd3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vd3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pixel_stride(t: torch.Tensor, shape: Tuple[int, ...], what: str) -> int:
    """The element stride between pixels of an NHWC-ordered per-pixel tensor
    whose channels are contiguous (a channel slice of a wider NHWC tensor,
    such as the offset half of the offset conv's output, qualifies). Raises
    on anything else, such as an NCHW tensor permuted to NHWC."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}')
    _, ho, wo, ch = shape
    s = t.stride(2)
    if t.stride(3) != 1 or s < ch or t.stride(1) != wo * s or t.stride(0) != ho * wo * s:
        raise ValueError(f'{what}: expected NHWC pixels with contiguous channels '
                         f'(a channels_last NCHW tensor permuted to NHWC); strides {t.stride()}')
    return s


def _check_cuda_input(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'{what}: expected a CUDA tensor, got one on {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{what}: expected {dtype} like x, got {t.dtype}')
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f'{what}: the deformable-conv kernel has no backward yet; '
                           'call it under torch.no_grad() or torch.inference_mode()')


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Modulated deformable conv (DCNv2) forward, JAX layouts (see the
    module docstring). The CUDA kernel on the card (the TPU
    ``_lerp_matmul_kernel`` / ``_lerp_matmul_f32_kernel``); the plain
    version for CPU tensors.

    On the card the weight is re-laid out to ``[K, C_in, C_out]`` on every
    call (a copy of at most 4.7 MB in the KM3D neck, ~3 us of bandwidth),
    not cached: a cache keyed on the tensor would go stale when weights are
    changed in place.
    """
    tensors = [x, offset, mask, weight] + ([] if bias is None else [bias])
    if all(t.device.type == 'cpu' for t in tensors):
        return modulated_deform_conv_plain(x, offset, mask, weight, bias, stride, padding,
                                           dilation)
    if x.dtype not in _ENTRY:
        raise TypeError(f'modulated_deform_conv: the kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    for t, what in zip(tensors, ('x', 'offset', 'mask', 'weight', 'bias')):
        _check_cuda_input(t, f'modulated_deform_conv({what})', x.dtype)
        if t.device != x.device:
            raise ValueError(f'modulated_deform_conv({what}) is on {t.device}, x on {x.device}')
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f'modulated_deform_conv: expected x [B, H, W, C] and weight '
                         f'[kh, kw, C_in, C_out], got {tuple(x.shape)} and {tuple(weight.shape)}')
    if not x.is_contiguous():
        raise ValueError(f'modulated_deform_conv(x): expected a contiguous NHWC tensor '
                         f'(a channels_last NCHW tensor permuted to NHWC); strides {x.stride()}')
    b, h, w, c_in = x.shape
    kh, kw, w_in, c_out = weight.shape
    if w_in != c_in:
        raise ValueError(f'modulated_deform_conv: weight takes {w_in} channels, x has {c_in}')
    if bias is not None and tuple(bias.shape) != (c_out,):
        raise ValueError(f'modulated_deform_conv(bias): expected ({c_out},), got {tuple(bias.shape)}')
    k = kh * kw
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    off_stride = pixel_stride(offset, (b, ho, wo, 2 * k), 'modulated_deform_conv(offset)')
    mask_stride = pixel_stride(mask, (b, ho, wo, k), 'modulated_deform_conv(mask)')
    wk = weight.reshape(k * c_in, c_out).contiguous()
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty((b, ho, wo, c_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _deform_conv_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wk.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, c_in, ho, wo, c_out, kh, kw, stride, padding, dilation,
            off_stride, mask_stride, stream)
    if rc != 0:
        raise RuntimeError(f'deformable-conv kernel launch failed: '
                           f'{lib.vd3d_cuda_error_string(rc).decode()} (cudaError {rc}); '
                           f'x {tuple(x.shape)} weight {tuple(weight.shape)} stride {stride} '
                           f'padding {padding} dilation {dilation} dtype {x.dtype}')
    LAUNCHES['modulated_deform_conv'] += 1
    return out


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """Plain (v1, non-modulated) deformable conv: a mask of ones."""
    b, ho, wo = offset.shape[:3]
    ones = torch.ones((b, ho, wo, offset.shape[-1] // 2), dtype=x.dtype, device=x.device)
    return modulated_deform_conv(x, offset, ones, weight, bias, stride, padding, dilation)
