"""OpenCV's StereoBM block matcher at the parameters of the disparity
precompute (``cv2.StereoBM_create(192, 25)``, the JAX package's
``visualdet3d_tpu/cli/disparity_compute.py:41``), bit for bit.

:func:`stereo_bm` takes two uint8 grey images [H, W] and returns the int16
disparity of the left one, times 16, with ``FILTERED`` (-16) where the
matcher finds none. The steps, all in integer arithmetic:

1. the XSOBEL prefilter of each eye: the 3x3 Sobel-x response
   ``d(up) + 2 d(row) + d(down)`` of ``d = I[x+1] - I[x-1]``, clamped to
   [-31, 31] and offset by 31; border rows mirrored (row -1 is row 1, row H
   is row H-2), the first and last columns 31, and with an odd height the
   last row 31 too (OpenCV filters rows in pairs);
2. for every pixel of the valid region (rows 12..H-13, columns 203..W-13)
   and every disparity D = 0..191, the SAD of the prefiltered eyes over the
   25x25 window, left at column x, right at x - D. OpenCV walks the index
   d = 191 - D, so the least SAD wins and, among equal ones, the largest D;
3. the texture check: the window's sum of |prefiltered left - 31| below 10
   filters the pixel;
4. the uniqueness check: a d with |d - best| > 1 and
   ``SAD[d] <= minSAD + minSAD * 15 / 100`` filters the pixel;
5. the subpixel step on the neighbours p = SAD[best + 1], n = SAD[best - 1]
   (mirrored at the ends): ``(D * 256 + (p - n) * 256 / k + 15) >> 4`` with
   ``k = p + n - 2 minSAD + |p - n|`` (0 when k is 0), C division.

Outside the valid region every pixel is ``FILTERED``.

:func:`stereo_bm_plain` is the plain PyTorch version: int32 tensors, the
disparities in chunks of ``CHUNK``, so that a 288x1280 pair needs some
200 MB. The wrapper takes it only for tensors on the CPU; a CUDA tensor
launches the hand-written kernel ``csrc/stereo_bm.cu`` or raises. The JAX package runs
this on the host through OpenCV, so the kernel replaces no Pallas kernel.
Launches are counted in ``LAUNCHES``: each kernel launch, so two a call
(the prefilter of both eyes, then the matcher).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from visualdet3d_tpu_torch.ops import kernel_build

NUM_DISPARITIES = 192
BLOCK_SIZE = 25
PREFILTER_CAP = 31
TEXTURE_THRESHOLD = 10
UNIQUENESS_RATIO = 15
DISP_SHIFT = 4
FILTERED = -(1 << DISP_SHIFT)  # (minDisparity - 1) << 4
CHUNK = 32                     # the plain version's disparities a step
LAUNCHES = {'stereo_bm': 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def valid_region(h: int, w: int):
    """(y0, y1, x0, x1): the rows [y0, y1) and columns [x0, x1) the matcher
    computes (OpenCV's ``getValidDisparityROI``), or None when it is empty."""
    r = BLOCK_SIZE // 2
    y0, y1, x0, x1 = r, h - r, NUM_DISPARITIES - 1 + r, w - r
    return (y0, y1, x0, x1) if y1 > y0 and x1 > x0 else None


def prefilter_xsobel_plain(image: torch.Tensor) -> torch.Tensor:
    """OpenCV's XSOBEL prefilter of a uint8 [H, W] image: int32 in [0, 2 cap]."""
    cap = PREFILTER_CAP
    h, w = image.shape
    out = torch.full((h, w), cap, dtype=torch.int32, device=image.device)
    if h < 2 or w < 3:
        return out
    x = image.to(torch.int32)
    dx = x[:, 2:] - x[:, :-2]
    rows = torch.arange(h, device=image.device)
    up = torch.where(rows > 0, rows - 1, 1)
    down = torch.where(rows < h - 1, rows + 1, h - 2)
    v = (dx[up] + 2 * dx + dx[down]).clamp(-cap, cap) + cap
    out[:, 1:-1] = v
    if h % 2:
        out[-1] = cap
    return out


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sums over the (2r+1)^2 windows of the last two dims that lie inside.
    The sums are of integers in floats whose partial sums stay below 2^24
    (the caller's dtype), so they are exact in any order."""
    k = 2 * r + 1
    c = x.cumsum(-2)
    x = torch.cat([c[..., k - 1:k, :], c[..., k:, :] - c[..., :-k, :]], -2)
    c = x.cumsum(-1)
    return torch.cat([c[..., k - 1:k], c[..., k:] - c[..., :-k]], -1)


def stereo_bm_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`stereo_bm` (see the module)."""
    _check_pair(left, right)
    h, w = left.shape
    out = torch.full((h, w), FILTERED, dtype=torch.int16, device=left.device)
    roi = valid_region(h, w)
    if roi is None:
        return out
    y0, y1, x0, x1 = roi
    r, nd, chunk = BLOCK_SIZE // 2, NUM_DISPARITIES, CHUNK
    # float sums of integers are exact while they stay below 2^24
    exact = torch.float32 if (w + h) * 2 * PREFILTER_CAP * BLOCK_SIZE < 2 ** 24 else torch.float64
    lf = prefilter_xsobel_plain(left).to(exact)
    rf = prefilter_xsobel_plain(right).to(exact)
    # the window columns of the valid region: [x0 - r, x1 + r), at disparity
    # D the right eye's [x0 - r - D, x1 + r - D)
    lw = lf[:, x0 - r:x1 + r]
    texture = _box((lw - PREFILTER_CAP).abs(), r)          # [y1 - y0, x1 - x0]
    windows = rf.unfold(1, lw.shape[1], 1)                 # [H, nd, Wc]: start nd-1-D = d
    big = float(2 ** 30)
    # per chunk of indices: its least SAD and first index of it, the SADs
    # next to that, and its least SAD leaving out [i-1, i+1], its first
    # index, its last index
    least, first, nxt, prv, apart, no_first, no_last, base = ([] for _ in range(8))
    for a in range(0, nd, chunk):
        b = min(a + chunk, nd)
        lo, hi = max(a - 1, 0), min(b + 1, nd)
        s = _box((lw[:, None, :] - windows[:, lo:hi]).abs().permute(1, 0, 2), r)
        parts = [s[1:2]] if a == 0 else []                    # SAD[-1] = SAD[1]
        parts.append(s)
        if b == nd:
            parts.append(s[-2:-1])                            # SAD[nd] = SAD[nd-2]
        ext = torch.cat(parts) if len(parts) > 1 else s       # indices a-1 .. b
        mid = ext[1:-1]                                       # indices a .. b-1
        m, i = mid.min(0)                                     # the first least: the least d
        band = (torch.arange(b - a, device=left.device)[:, None, None] - i).abs() <= 1
        least.append(m)
        first.append(i)
        nxt.append(ext.gather(0, (i + 2)[None])[0])
        prv.append(ext.gather(0, i[None])[0])
        apart.append(torch.where(band, big, mid).min(0).values)
        no_first.append(mid[1:].min(0).values if b - a > 1 else torch.full_like(m, big))
        no_last.append(mid[:-1].min(0).values if b - a > 1 else torch.full_like(m, big))
        base.append(a)
    least = torch.stack(least)
    best, c = least.min(0)                                    # the first chunk: the least d
    pick = lambda xs: torch.stack(xs).gather(0, c[None])[0]
    i = pick(first)
    best_d = i + torch.tensor(base, device=left.device)[c]
    p, n = pick(nxt), pick(prv)
    # the least SAD at |d - best_d| > 1, chunk by chunk
    cs = torch.arange(len(base), device=left.device)[:, None, None]
    size = torch.tensor([min(a + chunk, nd) - a for a in base], device=left.device)[c]
    other = torch.where(cs == c, torch.stack(apart), least)
    other = torch.where((cs == c - 1) & (i == 0), torch.stack(no_last), other)
    other = torch.where((cs == c + 1) & (i == size - 1), torch.stack(no_first), other)
    best, p, n, other = (v.to(torch.int32) for v in (best, p, n, other.min(0).values))
    thresh = best + best * UNIQUENESS_RATIO // 100
    keep = (texture >= TEXTURE_THRESHOLD) & (other > thresh)
    k = p + n - 2 * best + (p - n).abs()
    frac = torch.where(k != 0, torch.div((p - n) * 256, k.clamp_min(1), rounding_mode='trunc'),
                       torch.zeros_like(k))
    disp = ((nd - 1 - best_d).to(torch.int32) * 256 + frac + 15) >> DISP_SHIFT
    out[y0:y1, x0:x1] = torch.where(keep, disp, FILTERED).to(torch.int16)
    return out


def _check_pair(left: torch.Tensor, right: torch.Tensor) -> None:
    for what, x in (('left', left), ('right', right)):
        if x.dtype != torch.uint8 or x.dim() != 2:
            raise ValueError(f'stereo_bm({what}): expected a uint8 [H, W] image, '
                             f'got {x.dtype} {tuple(x.shape)}')
    if left.shape != right.shape or left.device != right.device:
        raise ValueError(f'stereo_bm: left {tuple(left.shape)} on {left.device} and right '
                         f'{tuple(right.shape)} on {right.device} differ')


@functools.lru_cache(maxsize=None)
def _stereo_bm_lib() -> ctypes.CDLL:
    lib = kernel_build.load('stereo_bm')
    lib.vd3d_stereo_bm.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 2
                                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])
    lib.vd3d_stereo_bm.restype = ctypes.c_int
    lib.vd3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vd3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def stereo_bm(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``cv2.StereoBM_create(192, 25).compute(left, right)``: int16 [H, W],
    the disparity times 16. CPU tensors take :func:`stereo_bm_plain`; CUDA
    tensors (any strides) the kernel."""
    if left.device.type == 'cpu' and right.device.type == 'cpu':
        return stereo_bm_plain(left, right)
    _check_pair(left, right)
    if left.device.type != 'cuda':
        raise ValueError(f'stereo_bm: expected CPU or CUDA tensors, got {left.device}')
    h, w = left.shape
    out = torch.empty((h, w), dtype=torch.int16, device=left.device)
    if out.numel() == 0:
        return out
    # the prefiltered eyes, u8, the kernel's scratch
    scratch = torch.empty((2, h, w), dtype=torch.uint8, device=left.device)
    lib = _stereo_bm_lib()
    with torch.cuda.device(left.device):
        rc = lib.vd3d_stereo_bm(left.data_ptr(), left.stride(0), left.stride(1),
                                right.data_ptr(), right.stride(0), right.stride(1),
                                scratch.data_ptr(), out.data_ptr(), h, w,
                                torch.cuda.current_stream(left.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'vd3d_stereo_bm launch failed: '
                           f'{lib.vd3d_cuda_error_string(rc).decode()} (cudaError {rc}); '
                           f'H={h} W={w}')
    LAUNCHES['stereo_bm'] += 2  # the prefilter kernel and the matcher kernel
    return out
