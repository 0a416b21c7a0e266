"""Deformable convolution v1/v2 (counterpart of ``visualdet3d_tpu/ops/deform_conv.py``).

Layouts follow the JAX package: NHWC ``x`` and output, offsets
``[B, Ho, Wo, 2K]`` with (dy, dx) of tap k at channels (2k, 2k+1) and taps
row-major, mask ``[B, Ho, Wo, K]`` (post-sigmoid), weight HWIO.

The forward and the backward are the hand-written CUDA kernels of
``csrc/deform_conv.cu`` (they replace the Pallas kernels
``_lerp_matmul_kernel`` (bf16 forward), ``_lerp_matmul_alltaps_kernel``
(the same bf16 forward, all taps and all output channels of a pixel tile in
one block), ``_lerp_matmul_f32_kernel`` (f32 forward), ``_lerp_accum_kernel``
(the lerp-accumulate of a table pre-multiplied by the tap weights) and
``_lerp_matmul_bwd_kernel`` (the backward, here also instantiated in f32)),
joined by a ``torch.autograd.Function``. The wrappers take the plain
PyTorch version only for tensors on the CPU (the backward: autograd through
the plain forward); a CUDA tensor launches the kernel or raises. Launches
are counted in ``LAUNCHES``. The per-tap forward and the backward's dW pass
are warp-specialised: producer warps gather and lerp the samples into a
ring of shared-memory stages while consumer warps run the products
(:func:`consumer_warps`); dW is summed in :func:`dw_plan`'s splits of the
batch's pixels (:func:`dw_stages`) into partial sums that a second kernel
adds in split order (:func:`dw_tile`, :func:`dw_rows`: a block's tile).
The backward's dx kernel in bf16 sums the corner gradients of each 2-D tile
of 64 output pixels in a shared-memory window of the input (offsets up to
``DX_WINDOW_RADIUS`` px; the tile is :func:`dx_plan`'s) before it adds them
into dx; :func:`dx_window_spill` counts its adds into device memory. In f32
it adds every corner into dx itself (the faster design there).

Forward variants (:func:`forward_variant`), chosen per call as the JAX
package chooses them: the environment switches ``VD3D_DCN_PREMUL=1`` and
``VD3D_DCN_ALLTAPS=1`` (read at call time; the JAX package reads them at
trace time) and the JAX package's gates select ``'premul'`` (bf16
inference, ``C_out < C_in``: ``Y = x @ W'`` for all taps at once, then
the lerp of ``Y``'s corners summed over taps; a different rounding: the
sampled value is not rounded to bf16), ``'alltaps'`` (the same function as
the per-tap kernel) or ``'per_tap'``.

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
import os
from typing import Optional, Tuple

import torch

from visualdet3d_tpu_torch.ops import kernel_build

# launches of the CUDA kernels, one key per kernel (a backward call
# launches three: dx and the lerp-weight gradients, dW's split partial sums,
# then their reduce into dW); reset with reset_launch_counts()
LAUNCHES = {'modulated_deform_conv': 0, 'modulated_deform_conv_alltaps': 0,
            'modulated_deform_conv_premul_accum': 0,
            'modulated_deform_conv_backward_input': 0,
            'modulated_deform_conv_backward_weight': 0,
            'modulated_deform_conv_backward_weight_reduce': 0}

_ENTRY = {torch.float32: 'vd3d_modulated_deform_conv_f32',
          torch.bfloat16: 'vd3d_modulated_deform_conv_bf16'}
_BWD_ENTRY = {torch.float32: 'vd3d_modulated_deform_conv_backward_f32',
              torch.bfloat16: 'vd3d_modulated_deform_conv_backward_bf16'}
_ALLTAPS_ENTRY = 'vd3d_modulated_deform_conv_alltaps_bf16'
_PREMUL_ENTRY = 'vd3d_premul_lerp_accumulate_bf16'


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def output_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int,
              dilation: int) -> Tuple[int, int]:
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    return ho, wo


def _tpu_tile_fits(hw: int, per_row: int, budget: int, fixed: int = 0) -> bool:
    """Whether a JAX Pallas forward kernel finds a pixel tile for ``hw``
    output pixels: its smallest tile, 8 rows, must divide ``hw``, and its
    VMEM use (``per_row`` bytes a row plus ``fixed``) must fit ``budget``
    (``_pick_pixrows``, ``_pick_pixrows_alltaps``)."""
    return hw % 8 == 0 and 8 * per_row + fixed <= budget


def forward_variant(hw: int, c_in: int, c_out: int, dtype: torch.dtype, train: bool = False,
                    taps: int = 9) -> str:
    """The forward variant for a DCN of ``hw`` output pixels and ``taps``
    kernel taps: ``'premul'``, ``'alltaps'`` or ``'per_tap'``, as the JAX
    package's ``modulated_deform_conv`` chooses its Pallas kernel.

    ``VD3D_DCN_PREMUL=1``: bf16 inference (not ``train``) with
    ``C_out % 64 == 0`` and ``C_out < C_in`` takes the pre-multiplied
    table (``_premul_ok``). ``VD3D_DCN_ALLTAPS=1``: the other bf16 calls on
    the JAX packed path (``_packed_ok``: ``C_in % 64 == 0``), training too,
    whose tap weights take at most 4 MiB in bf16, take all taps per block
    (``_pick_pixrows_alltaps``). f32 always takes the per-tap kernel.

    The pixel-count and VMEM conditions are TPU tiling gates (8-row tiles,
    the TPU kernels' VMEM budgets; every neck DCN of the ported models
    passes the budgets): the port's kernels do not need them and keep them
    only so as to compute the same function as the JAX package at every
    shape, the premul variant rounding differently from the others.
    """
    if dtype != torch.bfloat16:
        return 'per_tap'
    packed_row = lambda c, co: 2 * (2 * c * 4 + 128 * 4) + 5 * 2 * c * 4 + max(co, 128) * 6
    if (os.environ.get('VD3D_DCN_PREMUL') == '1' and not train and c_out % 64 == 0
            and c_out < c_in and _tpu_tile_fits(hw, packed_row(c_out, c_out), 8 << 20)):
        return 'premul'
    w_bytes = taps * c_in * c_out * 2
    alltaps_row = (2 * taps * 2 * c_in * 4 + 2 * taps * 128 * 2 + 4 * 2 * c_in * 4
                   + c_out * 6)
    if (os.environ.get('VD3D_DCN_ALLTAPS') == '1' and c_in % 64 == 0
            and _tpu_tile_fits(hw, packed_row(c_in, c_out), 8 << 20)
            and w_bytes <= 4 << 20 and _tpu_tile_fits(hw, alltaps_row, 10 << 20, w_bytes)):
        return 'alltaps'
    return 'per_tap'


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


def _corners(offset: torch.Tensor, mask: torch.Tensor, h: int, w: int, kh: int, kw: int,
             stride: int, padding: int, dilation: int, dtype: torch.dtype):
    """The integer corners (y0, x0) [B, Ho, Wo, K] of every tap's sample,
    clamped before the integer cast (|offset| may be huge; [-2, H] keeps
    every corner's inside/outside verdict), and the four lerp weights."""
    ho, wo = offset.shape[1:3]
    y0, x0, weights = _lerp_weights(offset, mask, ho, wo, kh, kw, stride, padding, dilation,
                                    dtype)
    return y0.clamp(-2, h).long(), x0.clamp(-2, w).long(), weights


def _sample_tap(table: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, weights, k: int,
                h: int, w: int) -> torch.Tensor:
    """Tap k's bilinear sample of ``table`` [B, H*W, C] (the image, or the
    pre-multiplied table's tap-k slice): the y lerp of each corner column,
    then the x lerp, each product and sum rounded on its own; a corner
    outside the image contributes 0. Returns [B, Ho*Wo, C]."""
    b, c = table.shape[0], table.shape[-1]
    yk, xk = y0[..., k], x0[..., k]
    wx0, wx1, wy0, wy1 = (t[..., k].reshape(b, -1, 1) for t in weights)

    def corner(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, -1)
        v = table.gather(1, idx[..., None].expand(-1, -1, c))
        return torch.where(inside.reshape(b, -1, 1), v, 0.0)
    vx0 = corner(yk, xk) * wy0 + corner(yk + 1, xk) * wy1
    vx1 = corner(yk, xk + 1) * wy0 + corner(yk + 1, xk + 1) * wy1
    return vx0 * wx0 + vx1 * wx1


def modulated_deform_conv_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                                stride: int = 1, padding: int = 1,
                                dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward with the kernel's rounding points (see
    the module docstring), differentiable by autograd; f64 inputs compute in
    f64 throughout. x [B, H, W, C_in],
    offset [B, Ho, Wo, 2K], mask [B, Ho, Wo, K], weight [kh, kw, C_in, C_out],
    bias [C_out] -> [B, Ho, Wo, C_out] in x's dtype. The plain version of
    the per-tap and the all-taps kernels, which compute the same function."""
    b, h, w, c_in = x.shape
    kh, kw, _, c_out = weight.shape
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    dtype = x.dtype
    y0, x0, weights = _corners(offset, mask, h, w, kh, kw, stride, padding, dilation, dtype)
    acc_dtype = _acc_dtype(dtype)
    flat = x.reshape(b, h * w, c_in).to(acc_dtype)
    wk = weight.reshape(kh * kw, c_in, c_out).to(acc_dtype)
    acc = torch.zeros((b, ho * wo, c_out), dtype=acc_dtype, device=x.device)
    for k in range(kh * kw):
        sampled = _sample_tap(flat, y0, x0, weights, k, h, w)
        # bf16: the sampled value is rounded before the tap product; the
        # product of two bf16 values is exact in f32
        sampled = sampled.to(dtype).to(acc_dtype)
        acc = acc + sampled @ wk[k]
    out = acc.to(dtype).reshape(b, ho, wo, c_out)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def _premul_weight(weight: torch.Tensor) -> torch.Tensor:
    """weight [kh, kw, C_in, C_out] -> W' [C_in, K*C_out], tap-major columns."""
    kh, kw, c_in, c_out = weight.shape
    return weight.reshape(kh * kw, c_in, c_out).permute(1, 0, 2).reshape(c_in, -1)


def premul_table_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The pre-multiplied table ``Y = x @ W'`` [B, H, W, K*C_out] of x
    [B, H, W, C_in] and weight [kh, kw, C_in, C_out]: the products summed in
    f32 (exact for bf16 values) and rounded once to x's dtype, as the JAX
    package's einsum with a bf16 result. ``Y[..., k*C_out:(k+1)*C_out]`` is
    ``x @ W_k``."""
    acc_dtype = _acc_dtype(x.dtype)
    return (x.to(acc_dtype) @ _premul_weight(weight).to(acc_dtype)).to(x.dtype)


def premul_lerp_accumulate_plain(y: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None,
                                 kernel_size: Tuple[int, int] = (3, 3), stride: int = 1,
                                 padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """The plain version of the lerp-accumulate kernel: for each tap k, the
    bilinear sample of ``Y``'s tap-k slice at the tap's deformed position
    (the lerp of ``_sample_tap``, in f32, not rounded), summed over taps in
    f32 in tap order, rounded once to Y's dtype, then ``+ bias`` in that
    dtype. y [B, H, W, K*C_out] (:func:`premul_table_plain`), offset
    [B, Ho, Wo, 2K], mask [B, Ho, Wo, K], bias [C_out] -> [B, Ho, Wo, C_out]."""
    b, h, w, kc = y.shape
    kh, kw = kernel_size
    k_taps = kh * kw
    c_out = kc // k_taps
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    dtype = y.dtype
    y0, x0, weights = _corners(offset, mask, h, w, kh, kw, stride, padding, dilation, dtype)
    acc_dtype = _acc_dtype(dtype)
    table = y.reshape(b, h * w, k_taps, c_out).to(acc_dtype)
    acc = torch.zeros((b, ho * wo, c_out), dtype=acc_dtype, device=y.device)
    for k in range(k_taps):
        acc = acc + _sample_tap(table[:, :, k], y0, x0, weights, k, h, w)
    out = acc.to(dtype).reshape(b, ho, wo, c_out)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def modulated_deform_conv_premul_plain(x: torch.Tensor, offset: torch.Tensor,
                                       mask: torch.Tensor, weight: torch.Tensor,
                                       bias: Optional[torch.Tensor] = None, stride: int = 1,
                                       padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the pre-multiplied DCNv2 forward (the JAX
    package's ``_premul_conv``): bilinear sampling is linear, so
    ``lerp(x) @ W_k == lerp(x @ W_k)`` up to rounding; the table is formed
    first, then lerped and summed over taps. Arguments as
    :func:`modulated_deform_conv_plain`."""
    kh, kw = weight.shape[:2]
    return premul_lerp_accumulate_plain(premul_table_plain(x, weight), offset, mask, bias,
                                        (kh, kw), stride, padding, dilation)


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


def consumer_warps(nt: int) -> int:
    """Consumer warps of a forward or dW block whose tile is ``nt`` x 64
    output channels wide (``csrc/deform_conv.cu``, ``consumer_warps``)."""
    return 4 if nt == 1 else 8


def dw_tile(c_out: int) -> Tuple[int, int]:
    """The dW kernel's block tile, (rows, columns): rows are (tap, input
    channel) pairs, columns output channels; 64, 128 or 256 columns as C_out
    needs, a 32 x 64 tile of each consumer warp (``DwCfg``)."""
    nt = 1 if c_out <= 64 else 2 if c_out <= 128 else 4
    return 32 * consumer_warps(nt) // nt, 64 * nt


def dw_rows(c_in: int, c_out: int, taps: int = 9) -> Tuple[int, int, int, int]:
    """A dW block's rows, as the kernel's ``dw_rows`` forms them: (taps per
    block, input channels per block, blocks along the taps, blocks along
    C_in). The taps split into equal groups of at most rows // channels."""
    rows = dw_tile(c_out)[0]
    ci = min(c_in, rows)
    n_kb = -(-taps // (rows // ci))
    return -(-taps // n_kb), ci, n_kb, -(-c_in // ci)


def dw_tiles(c_in: int, c_out: int, taps: int = 9) -> int:
    """The (rows, columns) tiles of dW: the dW kernel's blocks per split."""
    _, _, n_kb, n_ccb = dw_rows(c_in, c_out, taps)
    return n_kb * n_ccb * -(-c_out // dw_tile(c_out)[1])


DW_STAGE_PIXELS = {torch.bfloat16: 64, torch.float32: 32}  # pixels of a dW stage
DW_TILE_OVERHEAD = 3  # stages' worth of a dW block's time outside its main loop
DW_MAX_WAVES = 8


def dw_stages(b: int, ho: int, wo: int, dtype: torch.dtype) -> int:
    """The dW kernel's stages over a batch of ``b`` maps of Ho x Wo output
    pixels: runs of ``DW_STAGE_PIXELS`` pixels of one image."""
    return b * -(-(ho * wo) // DW_STAGE_PIXELS[dtype])


@functools.lru_cache(maxsize=None)
def dw_plan(chunks: int, c_in: int, c_out: int, taps: int = 9, n_sm: int = 132) -> int:
    """The dW kernel's split of its ``chunks`` stages (:func:`dw_stages`):
    the number of blocks each (rows, columns) tile of dW is summed over, each
    taking an equal run of stages (the last may be shorter), none empty.
    With one block an SM, the time is about (waves) x (stages a split +
    ``DW_TILE_OVERHEAD``); the plan takes the split with the least, over
    the splits that fill 1 to ``DW_MAX_WAVES`` whole waves of ``n_sm``
    blocks, the fewest splits on a tie."""
    tiles = dw_tiles(c_in, c_out, taps)
    best = None
    for waves in range(1, DW_MAX_WAVES + 1):
        splits = max(1, min(chunks, waves * n_sm // tiles))
        per = -(-chunks // splits)
        splits = -(-chunks // per)  # every split non-empty
        cost = -(-tiles * splits // n_sm) * (per + DW_TILE_OVERHEAD)
        if best is None or (cost, splits) < best:
            best = (cost, splits)
    return best[1]


DX_WINDOW_RADIUS = 4  # the dx kernel's window reaches offsets up to +-4 px
DX_TILES = ((8, 8), (4, 16))  # output-pixel tiles (rows x columns) of the dx kernel


def dx_plan(ho: int, wo: int) -> Tuple[int, int]:
    """The dx kernel's tile of 64 output pixels, (rows, columns): 8x8, or
    4x16 where that covers the Ho x Wo map with fewer tiles."""
    return min(DX_TILES, key=lambda t: (-(-ho // t[0]) * -(-wo // t[1]), t[1]))


def dx_window(tile: Tuple[int, int], kh: int, kw: int, stride: int, dilation: int,
              radius: int = DX_WINDOW_RADIUS) -> Tuple[int, int]:
    """Rows and columns of a dx tile's window: the input pixels its taps
    reach with offsets up to +-radius, both corners of the lerp included."""
    return ((tile[0] - 1) * stride + (kh - 1) * dilation + 2 * radius + 2,
            (tile[1] - 1) * stride + (kw - 1) * dilation + 2 * radius + 2)


def dx_window_spill(offset: torch.Tensor, h: int, w: int, c_in: int, kh: int = 3, kw: int = 3,
                    stride: int = 1, padding: int = 1, dilation: int = 1,
                    radius: int = DX_WINDOW_RADIUS) -> dict:
    """Device-memory adds into dx of the bf16 backward for these offsets
    [B, Ho, Wo, 2K] (any device), counted as the kernel makes them:
    ``spilled``, corners inside the image but outside their block's window
    (one add per channel each); ``window``, the window cells that some
    corner lands in, added once per channel; ``global_adds``, their sum.
    Beside them ``corner_adds``, every corner inside the image once per
    channel (the adds of a kernel without a window, as the f32 one), and
    ``all_corners``, 4 K C_in per output pixel."""
    b, ho, wo = offset.shape[:3]
    k = kh * kw
    th, tw = dx_plan(ho, wo)
    win_h, win_w = dx_window((th, tw), kh, kw, stride, dilation, radius)
    dev = offset.device
    oy = torch.arange(ho, device=dev).view(1, ho, 1, 1)
    ox = torch.arange(wo, device=dev).view(1, 1, wo, 1)
    ky = (torch.arange(k, device=dev) // kw).view(1, 1, 1, k)
    kx = (torch.arange(k, device=dev) % kw).view(1, 1, 1, k)
    off = offset.float()
    y0 = torch.floor((oy * stride - padding + ky * dilation).float() + off[..., 0::2]).long()
    x0 = torch.floor((ox * stride - padding + kx * dilation).float() + off[..., 1::2]).long()
    wy0 = (oy // th) * th * stride - padding - radius
    wx0 = (ox // tw) * tw * stride - padding - radius
    tiles_x = -(-wo // tw)
    tile = (torch.arange(b, device=dev).view(b, 1, 1, 1) * -(-ho // th) + oy // th) * tiles_x + \
        ox // tw
    corner_adds, spilled, cells = 0, 0, []
    for cy in (0, 1):
        for cx in (0, 1):
            yy, xx = y0 + cy, x0 + cx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            ry, rx = yy - wy0, xx - wx0
            in_win = (ry >= 0) & (ry < win_h) & (rx >= 0) & (rx < win_w)
            corner_adds += int(inside.sum())
            spilled += int((inside & ~in_win).sum())
            keep = inside & in_win
            cells.append(((tile.expand_as(yy) * h + yy) * w + xx)[keep])
    window = int(torch.unique(torch.cat(cells)).numel())
    return dict(spilled=spilled * c_in, window=window * c_in,
                global_adds=(spilled + window) * c_in, corner_adds=corner_adds * c_in,
                all_corners=b * ho * wo * 4 * k * c_in, tile=(th, tw), window_hw=(win_h, win_w))


@functools.lru_cache(maxsize=None)
def _deform_conv_lib() -> ctypes.CDLL:
    lib = kernel_build.load('deform_conv')
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name in _BWD_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 17 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib_fn = getattr(lib, _ALLTAPS_ENTRY)
    lib_fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    lib_fn.restype = ctypes.c_int
    lib_fn = getattr(lib, _PREMUL_ENTRY)
    lib_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    lib_fn.restype = ctypes.c_int
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


def _call(entry: str, what: str, args, device: torch.device, detail: str) -> None:
    """Call a launcher of the library on ``device``'s current stream; raise
    if the launch was refused."""
    lib = _deform_conv_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f'{what} kernel launch failed: '
                           f'{lib.vd3d_cuda_error_string(rc).decode()} (cudaError {rc}); '
                           f'{detail}')


def _launch(entry: str, what: str, pointers, dims, conv, x: torch.Tensor,
            weight: torch.Tensor, extra: Tuple[int, ...] = ()) -> None:
    """Launch a forward or backward kernel of the library on x's device
    (``extra``: the launcher's arguments after the pixel strides)."""
    b, h, w, c_in, ho, wo, c_out, kh, kw, off_stride, mask_stride = dims
    _call(entry, what, (*pointers, b, h, w, c_in, ho, wo, c_out, kh, kw, *conv, off_stride,
                        mask_stride, *extra), x.device,
          f'x {tuple(x.shape)} weight {tuple(weight.shape)} '
          f'stride/padding/dilation {conv} dtype {x.dtype}')


def _forward_kernel(x, offset, mask, weight, bias, stride, padding, dilation,
                    alltaps: bool = False) -> torch.Tensor:
    """The per-tap forward kernel (bf16 and f32), or with ``alltaps`` the
    all-taps one (bf16)."""
    dims = _kernel_dims(x, offset, mask, weight, bias, stride, padding, dilation,
                        'modulated_deform_conv')
    b, _, _, c_in, ho, wo, c_out, kh, kw = dims[:9]
    if alltaps and x.dtype != torch.bfloat16:
        raise TypeError(f'modulated_deform_conv: the all-taps kernel takes bfloat16, got {x.dtype}')
    wk = weight.reshape(kh * kw * c_in, c_out).contiguous()
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty((b, ho, wo, c_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch(_ALLTAPS_ENTRY if alltaps else _ENTRY[x.dtype], 'deformable-conv',
            (x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wk.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr()),
            dims, (stride, padding, dilation), x, weight)
    LAUNCHES['modulated_deform_conv_alltaps' if alltaps else 'modulated_deform_conv'] += 1
    return out


def premul_table(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``Y = x @ W'`` [B, H, W, K*C_out]: :func:`premul_table_plain` for CPU
    tensors; on the card one ``torch.matmul`` in x's dtype (cuBLAS, f32
    accumulation), the counterpart of the JAX package's einsum outside its
    Pallas kernel."""
    if x.device.type == 'cpu' and weight.device.type == 'cpu':
        return premul_table_plain(x, weight)
    _check_cuda_input(x, 'premul_table(x)', x.dtype)
    _check_cuda_input(weight, 'premul_table(weight)', x.dtype)
    b, h, w, c_in = x.shape
    return torch.matmul(x.reshape(b * h * w, c_in), _premul_weight(weight)).reshape(b, h, w, -1)


def premul_lerp_accumulate(y: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           kernel_size: Tuple[int, int] = (3, 3), stride: int = 1,
                           padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """The lerp-accumulate over the pre-multiplied table ``y``
    [B, H, W, K*C_out] (the TPU ``_lerp_accum_kernel``):
    :func:`premul_lerp_accumulate_plain` for CPU tensors, the CUDA kernel
    (bf16) on the card. Offsets and mask as in :func:`modulated_deform_conv`
    (strided NHWC pixels allowed); returns [B, Ho, Wo, C_out]."""
    tensors = [y, offset, mask] + ([] if bias is None else [bias])
    if all(t.device.type == 'cpu' for t in tensors):
        return premul_lerp_accumulate_plain(y, offset, mask, bias, kernel_size, stride,
                                            padding, dilation)
    what = 'premul_lerp_accumulate'
    if y.dtype != torch.bfloat16:
        raise TypeError(f'{what}: the kernel takes bfloat16, got {y.dtype}')
    for t, name in zip(tensors, ('y', 'offset', 'mask', 'bias')):
        _check_cuda_input(t, f'{what}({name})', y.dtype)
        if t.device != y.device:
            raise ValueError(f'{what}({name}) is on {t.device}, y on {y.device}')
    kh, kw = kernel_size
    k = kh * kw
    if y.dim() != 4 or not y.is_contiguous() or y.shape[-1] % k:
        raise ValueError(f'{what}(y): expected a contiguous [B, H, W, {k} * C_out] tensor, got '
                         f'{tuple(y.shape)} with strides {y.stride()}')
    b, h, w, kc = y.shape
    c_out = kc // k
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    off_stride = pixel_stride(offset, (b, ho, wo, 2 * k), f'{what}(offset)')
    mask_stride = pixel_stride(mask, (b, ho, wo, k), f'{what}(mask)')
    if bias is not None:
        if tuple(bias.shape) != (c_out,):
            raise ValueError(f'{what}(bias): expected ({c_out},), got {tuple(bias.shape)}')
        bias = bias.contiguous()
    out = torch.empty((b, ho, wo, c_out), dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    _call(_PREMUL_ENTRY, what,
          (y.data_ptr(), offset.data_ptr(), mask.data_ptr(),
           None if bias is None else bias.data_ptr(), out.data_ptr(), b, h, w, ho, wo, c_out,
           kh, kw, stride, padding, dilation, off_stride, mask_stride), y.device,
          f'y {tuple(y.shape)} kernel {kernel_size} stride/padding/dilation '
          f'{(stride, padding, dilation)}')
    LAUNCHES['modulated_deform_conv_premul_accum'] += 1
    return out


def modulated_deform_conv_alltaps(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                                  stride: int = 1, padding: int = 1,
                                  dilation: int = 1) -> torch.Tensor:
    """The all-taps forward whatever the switches and gates say: the CUDA
    kernel (bf16) on the card, :func:`modulated_deform_conv_plain` (the same
    function) for CPU tensors. No gradient: :func:`modulated_deform_conv`
    is the differentiable op."""
    tensors = [x, offset, mask, weight] + ([] if bias is None else [bias])
    if all(t.device.type == 'cpu' for t in tensors):
        return modulated_deform_conv_plain(x, offset, mask, weight, bias, stride, padding,
                                           dilation)
    return _forward_kernel(x, offset, mask, weight, bias, stride, padding, dilation,
                           alltaps=True)


def modulated_deform_conv_premul(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                 weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                                 stride: int = 1, padding: int = 1,
                                 dilation: int = 1) -> torch.Tensor:
    """The pre-multiplied forward whatever the switches and gates say:
    :func:`premul_table` then :func:`premul_lerp_accumulate` (cuBLAS and
    the CUDA kernel on the card, :func:`modulated_deform_conv_premul_plain`
    for CPU tensors). No gradient: :func:`modulated_deform_conv` is the
    differentiable op."""
    tensors = [x, offset, mask, weight] + ([] if bias is None else [bias])
    if all(t.device.type == 'cpu' for t in tensors):
        return modulated_deform_conv_premul_plain(x, offset, mask, weight, bias, stride,
                                                  padding, dilation)
    kh, kw = weight.shape[:2]
    return premul_lerp_accumulate(premul_table(x, weight), offset, mask, bias, (kh, kw), stride,
                                  padding, dilation)


class _ModulatedDeformConv(torch.autograd.Function):
    """A forward variant (the kernels on the card; the premul variant's
    plain version on the CPU), with the DCN backward as its gradient (the
    backward kernel on the card, the plain backward on the CPU), as the JAX
    package's premul path takes the pairs formulation's vjp."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, stride, padding, dilation, variant):
        ctx.conv = (stride, padding, dilation)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, offset, mask, weight)
        if variant == 'premul':
            return modulated_deform_conv_premul(x, offset, mask, weight, bias, stride, padding,
                                                dilation)
        return _forward_kernel(x, offset, mask, weight, bias, stride, padding, dilation,
                               alltaps=variant == 'alltaps')

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        dx, d_offset, d_mask, d_weight = modulated_deform_conv_backward(
            x, offset, mask, weight, grad_out, *ctx.conv)
        d_bias = grad_out.sum(dim=(0, 1, 2)) if ctx.has_bias else None
        return dx, d_offset, d_mask, d_weight, d_bias, None, None, None, None


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: int = 1, dilation: int = 1,
                          train: bool = False) -> torch.Tensor:
    """Modulated deformable conv (DCNv2), JAX layouts (see the module
    docstring), differentiable in every tensor argument. The forward variant
    is :func:`forward_variant`'s (``train`` as the JAX op's: the premul
    variant is inference only). On the card the CUDA kernels (the TPU
    ``_lerp_matmul_kernel`` / ``_lerp_matmul_alltaps_kernel`` /
    ``_lerp_matmul_f32_kernel`` / ``_lerp_accum_kernel`` forward,
    ``_lerp_matmul_bwd_kernel`` backward); for CPU tensors the plain
    versions (the per-tap one under autograd).

    On the card the weight is re-laid out to ``[K, C_in, C_out]`` on every
    call (a copy of at most 4.7 MB in the KM3D neck, ~3 us of bandwidth),
    not cached: a cache keyed on the tensor would go stale when weights are
    changed in place.
    """
    variant = 'per_tap'
    if x.dim() == 4 and weight.dim() == 4:
        kh, kw, c_in, c_out = weight.shape
        ho, wo = output_hw(x.shape[1], x.shape[2], kh, kw, stride, padding, dilation)
        variant = forward_variant(ho * wo, c_in, c_out, x.dtype, train, kh * kw)
    tensors = [x, offset, mask, weight] + ([] if bias is None else [bias])
    if variant != 'premul' and all(t.device.type == 'cpu' for t in tensors):
        return modulated_deform_conv_plain(x, offset, mask, weight, bias, stride, padding,
                                           dilation)
    return _ModulatedDeformConv.apply(x, offset, mask, weight, bias, stride, padding, dilation,
                                      variant)


def modulated_deform_conv_backward(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                                   weight: torch.Tensor, grad_out: torch.Tensor,
                                   stride: int = 1, padding: int = 1, dilation: int = 1):
    """The backward of :func:`modulated_deform_conv` without its bias:
    (dx, d_offset, d_mask, d_weight), each in its input's dtype and shape,
    for the output gradient ``grad_out`` [B, Ho, Wo, C_out]. The CUDA
    kernels on the card; :func:`modulated_deform_conv_backward_plain` for
    CPU tensors.

    The kernels write dx (zeroed here) and dW in f32, rounded here once, and
    the gradients of the four lerp weights per (pixel, tap); ``_lerp_weights``
    under autograd carries those to d_offset and d_mask with the plain
    version's rounding points. dW is summed in :func:`dw_plan`'s splits into
    a partials buffer, then added up over the splits by a second kernel.
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
    dwts = torch.empty((b, ho, wo, k, 4), **f32)
    if grad_out.numel() > 0:
        splits = dw_plan(dw_stages(b, ho, wo, x.dtype), c_in, c_out, k,
                         torch.cuda.get_device_properties(x.device).multi_processor_count)
        dw = torch.empty((k * c_in, c_out), **f32)
        part = torch.empty((splits, k * c_in, c_out), **f32)
        _launch(_BWD_ENTRY[x.dtype], 'deformable-conv backward',
                (x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wk.data_ptr(),
                 grad_out.data_ptr(), dx.data_ptr(), dwts.data_ptr(), dw.data_ptr(),
                 part.data_ptr()),
                dims, (stride, padding, dilation), x, weight,
                (dx_plan(ho, wo)[1], DX_WINDOW_RADIUS, splits))
        for key in ('input', 'weight', 'weight_reduce'):
            LAUNCHES[f'modulated_deform_conv_backward_{key}'] += 1
    else:
        dw = torch.zeros((k * c_in, c_out), **f32)
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
