"""Deformable convolution v1/v2 (counterpart of ``visualdet3d_tpu/ops/deform_conv.py``).

Layouts follow the JAX package: NHWC ``x`` and output, offsets
``[B, Ho, Wo, 2K]`` with (dy, dx) of tap k at channels (2k, 2k+1) and taps
row-major, mask ``[B, Ho, Wo, K]`` (post-sigmoid), weight HWIO.

The forward and the backward are the hand-written CUDA kernels of
``csrc/deform_conv.cu`` (they replace the Pallas kernels
``_lerp_matmul_kernel`` (bf16 forward), ``_lerp_matmul_f32_kernel`` (f32
forward) and ``_lerp_matmul_bwd_kernel`` (the backward, here also
instantiated in f32)), joined by a ``torch.autograd.Function``. The wrappers
take the plain PyTorch version only for tensors on the CPU (the backward:
autograd through the plain forward); a CUDA tensor launches the kernel or
raises. Launches are counted in ``LAUNCHES``.

Rounding points (those of the JAX packed paths, which the kernels keep):
sample coordinates in f32 from the offsets cast to f32; the fractional
parts ``fx``, ``fy`` rounded to the input dtype; the four lerp weights
``1-fx``, ``fx``, ``(1-fy)*mask``, ``fy*mask`` formed in the input dtype;
the lerp in f32 (the y lerp per corner column, then the x lerp, each
product and sum rounded on its own: no fused multiply-add); in bf16 the
sampled value rounded to bf16 before the tap product; f32 accumulation;
the output rounded to the input dtype, then ``+ bias`` in that dtype. A
corner outside the image contributes 0 (the CUDA ``dmcn_im2col_bilinear``
rule). The backward kernel keeps the TPU kernel's: ``ds = dy . W_k^T`` and
``dW`` accumulated in f32 from products of input-dtype values, ``dW``
rounded to the weight's dtype at the end; ``dx`` is summed in f32 and
rounded once (the JAX package scatter-adds in bf16); the four lerp-weight
gradients are summed in f32 and carried to ``d_offset`` and ``d_mask`` by
the torch ops that form the weights (``_lerp_weights``), as in the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from visualdet3d_tpu_torch.ops import kernel_build

# launches of the CUDA kernels, one key per kernel (a backward call
# launches two: dx and the lerp-weight gradients, then dW); reset with
# reset_launch_counts()
LAUNCHES = {'modulated_deform_conv': 0, 'modulated_deform_conv_backward_input': 0,
            'modulated_deform_conv_backward_weight': 0}

_ENTRY = {torch.float32: 'vd3d_modulated_deform_conv_f32',
          torch.bfloat16: 'vd3d_modulated_deform_conv_bf16'}
_BWD_ENTRY = {torch.float32: 'vd3d_modulated_deform_conv_backward_f32',
              torch.bfloat16: 'vd3d_modulated_deform_conv_backward_bf16'}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def output_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int,
              dilation: int) -> Tuple[int, int]:
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    return ho, wo


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of coordinates, lerps and sums: f32, or f64 for f64 inputs
    (the plain version's gradient check)."""
    return torch.promote_types(dtype, torch.float32)


def _tap_coords(offset: torch.Tensor, ho: int, wo: int, kh: int, kw: int, stride: int,
                padding: int, dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 sample coordinates [B, Ho, Wo, K] (py, px) of every tap."""
    f32, dev = _acc_dtype(offset.dtype), offset.device
    base_y = torch.arange(ho, dtype=f32, device=dev) * stride - padding
    base_x = torch.arange(wo, dtype=f32, device=dev) * stride - padding
    tap_y = (torch.arange(kh, dtype=f32, device=dev) * dilation).repeat_interleave(kw)
    tap_x = (torch.arange(kw, dtype=f32, device=dev) * dilation).repeat(kh)
    offset = offset.to(f32)
    py = base_y[None, :, None, None] + tap_y + offset[..., 0::2]
    px = base_x[None, None, :, None] + tap_x + offset[..., 1::2]
    return py, px


def _lerp_weights(offset: torch.Tensor, mask: torch.Tensor, ho: int, wo: int, kh: int,
                  kw: int, stride: int, padding: int, dilation: int, dtype: torch.dtype):
    """The integer corner (y0, x0) [B, Ho, Wo, K] of every tap's sample and
    its four lerp weights ``1-fx``, ``fx``, ``(1-fy)*mask``, ``fy*mask``,
    formed in ``dtype`` and returned in f32. Differentiable in ``offset``
    and ``mask``: the kernel's backward carries its weight gradients to
    ``d_offset`` and ``d_mask`` through this function."""
    py, px = _tap_coords(offset, ho, wo, kh, kw, stride, padding, dilation)
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = (py - y0).to(dtype), (px - x0).to(dtype)
    mask = mask.to(dtype)
    acc = _acc_dtype(dtype)
    weights = ((1 - fx).to(acc), fx.to(acc), ((1 - fy) * mask).to(acc), (fy * mask).to(acc))
    return y0.detach(), x0.detach(), weights


def modulated_deform_conv_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                                stride: int = 1, padding: int = 1,
                                dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward with the kernel's rounding points (see
    the module docstring), differentiable by autograd; f64 inputs compute in
    f64 throughout. x [B, H, W, C_in],
    offset [B, Ho, Wo, 2K], mask [B, Ho, Wo, K], weight [kh, kw, C_in, C_out],
    bias [C_out] -> [B, Ho, Wo, C_out] in x's dtype."""
    b, h, w, c_in = x.shape
    kh, kw, _, c_out = weight.shape
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    dtype = x.dtype
    y0, x0, (wx0, wx1, wy0, wy1) = _lerp_weights(offset, mask, ho, wo, kh, kw, stride,
                                                 padding, dilation, dtype)
    # clamp before the integer cast (|offset| may be huge); [-2, H] keeps
    # every corner's inside/outside verdict
    y0 = y0.clamp(-2, h).long()
    x0 = x0.clamp(-2, w).long()

    acc_dtype = _acc_dtype(dtype)
    flat = x.reshape(b, h * w, c_in).to(acc_dtype)
    wk = weight.reshape(kh * kw, c_in, c_out).to(acc_dtype)
    acc = torch.zeros((b, ho * wo, c_out), dtype=acc_dtype, device=x.device)
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
        sampled = sampled.to(dtype).to(acc_dtype)
        acc = acc + sampled @ wk[k]
    out = acc.to(dtype).reshape(b, ho, wo, c_out)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def modulated_deform_conv_backward_plain(x: torch.Tensor, offset: torch.Tensor,
                                         mask: torch.Tensor, weight: torch.Tensor,
                                         grad_out: torch.Tensor, stride: int = 1,
                                         padding: int = 1, dilation: int = 1):
    """Plain backward: autograd through :func:`modulated_deform_conv_plain`
    (no bias). Returns (dx, d_offset, d_mask, d_weight), each in its input's
    dtype and shape."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, offset, mask, weight)]
        out = modulated_deform_conv_plain(*leaves, None, stride, padding, dilation)
        return torch.autograd.grad(out, leaves, grad_out)


@functools.lru_cache(maxsize=None)
def _deform_conv_lib() -> ctypes.CDLL:
    lib = kernel_build.load('deform_conv')
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name in _BWD_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
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


def _kernel_dims(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, bias: Optional[torch.Tensor], stride: int, padding: int,
                 dilation: int, what: str):
    """Raise on what the kernels do not take; else the shapes and the pixel
    strides of offset and mask:
    (b, h, w, c_in, ho, wo, c_out, kh, kw, off_stride, mask_stride)."""
    tensors = [x, offset, mask, weight] + ([] if bias is None else [bias])
    if x.dtype not in _ENTRY:
        raise TypeError(f'{what}: the kernel takes float32 or bfloat16, got {x.dtype}')
    for t, name in zip(tensors, ('x', 'offset', 'mask', 'weight', 'bias')):
        _check_cuda_input(t, f'{what}({name})', x.dtype)
        if t.device != x.device:
            raise ValueError(f'{what}({name}) is on {t.device}, x on {x.device}')
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f'{what}: expected x [B, H, W, C] and weight '
                         f'[kh, kw, C_in, C_out], got {tuple(x.shape)} and {tuple(weight.shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{what}(x): expected a contiguous NHWC tensor '
                         f'(a channels_last NCHW tensor permuted to NHWC); strides {x.stride()}')
    b, h, w, c_in = x.shape
    kh, kw, w_in, c_out = weight.shape
    if w_in != c_in:
        raise ValueError(f'{what}: weight takes {w_in} channels, x has {c_in}')
    if bias is not None and tuple(bias.shape) != (c_out,):
        raise ValueError(f'{what}(bias): expected ({c_out},), got {tuple(bias.shape)}')
    k = kh * kw
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    off_stride = pixel_stride(offset, (b, ho, wo, 2 * k), f'{what}(offset)')
    mask_stride = pixel_stride(mask, (b, ho, wo, k), f'{what}(mask)')
    return b, h, w, c_in, ho, wo, c_out, kh, kw, off_stride, mask_stride


def _launch(entry: str, what: str, pointers, dims, conv, x: torch.Tensor,
            weight: torch.Tensor) -> None:
    """Launch a kernel of the library on x's device and current stream;
    raise if the launch was refused."""
    b, h, w, c_in, ho, wo, c_out, kh, kw, off_stride, mask_stride = dims
    lib = _deform_conv_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(*pointers, b, h, w, c_in, ho, wo, c_out, kh, kw, *conv,
                                 off_stride, mask_stride, stream)
    if rc != 0:
        raise RuntimeError(f'{what} kernel launch failed: '
                           f'{lib.vd3d_cuda_error_string(rc).decode()} (cudaError {rc}); '
                           f'x {tuple(x.shape)} weight {tuple(weight.shape)} '
                           f'stride/padding/dilation {conv} dtype {x.dtype}')


def _forward_kernel(x, offset, mask, weight, bias, stride, padding, dilation) -> torch.Tensor:
    dims = _kernel_dims(x, offset, mask, weight, bias, stride, padding, dilation,
                        'modulated_deform_conv')
    b, _, _, c_in, ho, wo, c_out, kh, kw = dims[:9]
    wk = weight.reshape(kh * kw * c_in, c_out).contiguous()
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty((b, ho, wo, c_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch(_ENTRY[x.dtype], 'deformable-conv',
            (x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wk.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr()),
            dims, (stride, padding, dilation), x, weight)
    LAUNCHES['modulated_deform_conv'] += 1
    return out


class _ModulatedDeformConv(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, stride, padding, dilation):
        ctx.conv = (stride, padding, dilation)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, offset, mask, weight)
        return _forward_kernel(x, offset, mask, weight, bias, stride, padding, dilation)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        dx, d_offset, d_mask, d_weight = modulated_deform_conv_backward(
            x, offset, mask, weight, grad_out, *ctx.conv)
        d_bias = grad_out.sum(dim=(0, 1, 2)) if ctx.has_bias else None
        return dx, d_offset, d_mask, d_weight, d_bias, None, None, None


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Modulated deformable conv (DCNv2), JAX layouts (see the module
    docstring), differentiable in every tensor argument. On the card the
    CUDA kernels (the TPU ``_lerp_matmul_kernel`` / ``_lerp_matmul_f32_kernel``
    forward, ``_lerp_matmul_bwd_kernel`` backward); the plain version, under
    autograd, for CPU tensors.

    On the card the weight is re-laid out to ``[K, C_in, C_out]`` on every
    call (a copy of at most 4.7 MB in the KM3D neck, ~3 us of bandwidth),
    not cached: a cache keyed on the tensor would go stale when weights are
    changed in place.
    """
    tensors = [x, offset, mask, weight] + ([] if bias is None else [bias])
    if all(t.device.type == 'cpu' for t in tensors):
        return modulated_deform_conv_plain(x, offset, mask, weight, bias, stride, padding,
                                           dilation)
    return _ModulatedDeformConv.apply(x, offset, mask, weight, bias, stride, padding, dilation)


def modulated_deform_conv_backward(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                   weight: torch.Tensor, grad_out: torch.Tensor,
                                   stride: int = 1, padding: int = 1, dilation: int = 1):
    """The backward of :func:`modulated_deform_conv` without its bias:
    (dx, d_offset, d_mask, d_weight), each in its input's dtype and shape,
    for the output gradient ``grad_out`` [B, Ho, Wo, C_out]. The CUDA
    kernels on the card; :func:`modulated_deform_conv_backward_plain` for
    CPU tensors.

    The kernels write dx and dW in f32 (zeroed here, rounded here once) and
    the gradients of the four lerp weights per (pixel, tap); ``_lerp_weights``
    under autograd carries those to d_offset and d_mask with the plain
    version's rounding points.
    """
    tensors = (x, offset, mask, weight, grad_out)
    if all(t.device.type == 'cpu' for t in tensors):
        return modulated_deform_conv_backward_plain(x, offset, mask, weight, grad_out, stride,
                                                    padding, dilation)
    what = 'modulated_deform_conv_backward'
    dims = _kernel_dims(x, offset, mask, weight, None, stride, padding, dilation, what)
    b, h, w, c_in, ho, wo, c_out, kh, kw = dims[:9]
    _check_cuda_input(grad_out, f'{what}(grad_out)', x.dtype)
    if tuple(grad_out.shape) != (b, ho, wo, c_out) or grad_out.device != x.device:
        raise ValueError(f'{what}(grad_out): expected {(b, ho, wo, c_out)} on {x.device}, got '
                         f'{tuple(grad_out.shape)} on {grad_out.device}')
    k = kh * kw
    grad_out = grad_out.contiguous()
    wk = weight.reshape(k * c_in, c_out).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros((b, h, w, c_in), **f32)
    dw = torch.zeros((k * c_in, c_out), **f32)
    dwts = torch.empty((b, ho, wo, k, 4), **f32)
    if grad_out.numel() > 0:
        _launch(_BWD_ENTRY[x.dtype], 'deformable-conv backward',
                (x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wk.data_ptr(),
                 grad_out.data_ptr(), dx.data_ptr(), dwts.data_ptr(), dw.data_ptr()),
                dims, (stride, padding, dilation), x, weight)
        LAUNCHES['modulated_deform_conv_backward_input'] += 1
        LAUNCHES['modulated_deform_conv_backward_weight'] += 1
    else:
        dwts.zero_()
    with torch.enable_grad():
        off = offset.detach().requires_grad_()
        msk = mask.detach().requires_grad_()
        _, _, weights = _lerp_weights(off, msk, ho, wo, kh, kw, stride, padding, dilation,
                                      x.dtype)
        d_offset, d_mask = torch.autograd.grad(weights, (off, msk), dwts.unbind(-1))
    return dx.to(x.dtype), d_offset, d_mask, dw.to(weight.dtype).reshape(weight.shape)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """Plain (v1, non-modulated) deformable conv: a mask of ones."""
    b, ho, wo = offset.shape[:3]
    ones = torch.ones((b, ho, wo, offset.shape[-1] // 2), dtype=x.dtype, device=x.device)
    return modulated_deform_conv(x, offset, ones, weight, bias, stride, padding, dilation)
