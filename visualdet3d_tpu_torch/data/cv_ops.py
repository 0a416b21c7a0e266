"""Host image operations in place of the four OpenCV calls of the JAX
package's augmentations (``cv2.resize``, ``cv2.warpAffine``,
``cv2.cvtColor`` RGB <-> HSV): torch CPU ops and numpy, both of which
release the interpreter lock for the data loader's threads.

* :func:`resize`: bilinear with half-pixel centres (``INTER_LINEAR``, no
  antialiasing when shrinking) through ``F.interpolate(align_corners=False)``,
  or ``INTER_NEAREST``'s source index ``floor(dst * (1 / (out / in)))``
  (OpenCV's rounding: ``dst * in / out`` differs at exact multiples); a
  uint16 image (a KITTI depth map) takes OpenCV's own float arithmetic bit
  for bit (:func:`_resize_linear_u16`), and so does a float32 image inside
  :func:`exact_resize` (the StereoBM precompute's ground truth);
* :func:`warp_affine`: ``warpAffine(M, INTER_LINEAR)`` with a zero border,
  sampling each output pixel at ``M^-1 (x, y, 1)`` exactly (float64
  coordinates), bilinearly, through ``F.grid_sample``;
* :func:`rgb_to_hsv`, :func:`hsv_to_rgb`: OpenCV's float formulas (H in
  degrees, [0, 360); S and V unscaled), in float32;
* :func:`rgb_to_gray`: ``cvtColor(COLOR_RGB2GRAY)`` of a uint8 image, in
  OpenCV's 15-bit fixed point.

Images are [H, W] or [H, W, C] numpy arrays; the result keeps the input's
dtype (uint8 and uint16 are rounded and clipped, as OpenCV saturates).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

INTER_NEAREST, INTER_LINEAR = 0, 1
FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
_exact = threading.local()


@contextlib.contextmanager
def exact_resize():
    """Within it, :func:`resize` of a float32 image in this thread is
    ``cv2.resize``'s bit for bit (:func:`_resize_linear_f32`; ``F.interpolate``'s
    float32 source coordinates move a sample by up to ~1e-4 of the pixel
    step): for ground truth that must equal the JAX package's files. The
    loader, whose threads share the host's cores, keeps ``F.interpolate``:
    inside this mode the stereo config's train augmentation of a 375x1242
    pair takes more CPU time, measured by ``chip_smoke.py``'s
    ``stereo_bm_precompute`` line (``train_augmentation_ms``: wall and CPU
    ms of both paths; the numbers are in ``PERF.md`` §6)."""
    prev = getattr(_exact, 'on', False)
    _exact.on = True
    try:
        yield
    finally:
        _exact.on = prev


def _as_float_chw(image: np.ndarray) -> torch.Tensor:
    """[H, W(, C)] -> [1, C, H, W] float32 tensor (a view where it can be)."""
    t = torch.from_numpy(np.ascontiguousarray(image))
    if t.dim() == 2:
        t = t[:, :, None]
    return t.permute(2, 0, 1)[None].float()


def _back(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    """[1, C, H, W] float -> the layout and dtype of ``like``."""
    out = t[0].permute(1, 2, 0)
    if like.ndim == 2:
        out = out[:, :, 0]
    if like.dtype == np.uint8:
        out = out.round().clamp(0, 255)
    return np.ascontiguousarray(out.to(torch.from_numpy(like[:0]).dtype).numpy())


def resize(image: np.ndarray, size_wh: Tuple[int, int],
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(image, size_wh, interpolation=...)``: ``size_wh`` is
    (width, height), as OpenCV takes it."""
    w, h = int(size_wh[0]), int(size_wh[1])
    if interpolation == INTER_NEAREST:
        rows = np.minimum(np.floor(np.arange(h) * (1.0 / (h / image.shape[0]))).astype(np.int64),
                          image.shape[0] - 1)
        cols = np.minimum(np.floor(np.arange(w) * (1.0 / (w / image.shape[1]))).astype(np.int64),
                          image.shape[1] - 1)
        return np.ascontiguousarray(image[rows][:, cols])
    if interpolation != INTER_LINEAR:
        raise NotImplementedError(f'interpolation {interpolation}')
    if image.dtype == np.uint16:
        return _resize_linear_u16(image, w, h)
    if image.dtype == np.float32 and getattr(_exact, 'on', False):
        return _resize_linear_f32(image, w, h)
    out = F.interpolate(_as_float_chw(image), size=(h, w), mode='bilinear',
                        align_corners=False, antialias=False)
    return _back(out, image)


def _fma32(a, b, c) -> np.ndarray:
    """``fmaf(a, b, c)``: a * b + c rounded once to float32, for float32
    inputs. The product of two 24-bit significands is exact in float64; the
    sum is rounded to float64 and then to float32, and where the float64
    sum was inexact (its two-sum error is not 0) and falls exactly on a
    float32 tie, the error breaks the tie as the single rounding would."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    inexact = np.nonzero(err)
    if inexact[0].size:
        s_i, r_i, e_i = s[inexact], r[inexact], err[inexact]
        other = np.nextafter(r_i, np.where(s_i > r_i, np.float32(np.inf), np.float32(-np.inf)))
        tie = (r_i.astype(np.float64) + other.astype(np.float64)) / 2 == s_i
        r[inexact] = np.where(tie & ((e_i > 0) == (other > r_i)), other, r_i)
    return r


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's linear taps along one axis: the source coordinate
    ``(d + 0.5) * (1 / (out / in)) - 0.5`` in float64, its floor and
    fraction (the fraction rounded to float32), clamped at both borders
    to the edge sample with fraction 0."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    lo = np.floor(f)
    frac = (f - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    frac[(lo < 0) | (lo >= n_in - 1)] = 0
    lo = np.clip(lo, 0, n_in - 1)
    return lo, np.minimum(lo + 1, n_in - 1), frac


def _fma_lerp(t: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fmaf(t, b - a, a)`` of float32 ``a``, ``b`` and float64 ``t`` (a
    float32 value), broadcast: the product of two 24-bit significands is
    exact in float64, so one float64 rounding and the cast to float32 give
    the single rounding, except where the float64 sum falls exactly halfway
    between two float32 values (its low 29 bits 1 followed by 0s) or below
    float32's normal range: those few take :func:`_fma32`."""
    s = torch.addcmul(a.double(), t, (b - a).double())
    r = s.float()
    risky = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | (s.abs() < 2.0 ** -125)
    if bool(risky.any()):
        at = risky.nonzero(as_tuple=True)
        tt, aa, bb = (v.expand_as(r)[at].float().numpy() for v in (t, a, b))
        r[at] = torch.from_numpy(_fma32(tt, bb - aa, aa))
    return r


def _resize_linear_f32(image: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(image, (w, h))`` of a float32 image, bit for bit:
    OpenCV resizes each row first, then the columns, each output the lerp
    ``fmaf(t, b - a, a)`` of its two taps (:func:`_linear_taps`)."""
    out = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    trail = (1,) * (image.ndim - 2)
    if w != image.shape[1]:  # at the same size every fraction is 0: the identity
        x0, x1, fx = (torch.from_numpy(v) for v in _linear_taps(image.shape[1], w))
        out = _fma_lerp(fx.double().view((1, -1) + trail), out.index_select(1, x0),
                        out.index_select(1, x1))
    if h != image.shape[0]:
        y0, y1, fy = (torch.from_numpy(v) for v in _linear_taps(image.shape[0], h))
        out = _fma_lerp(fy.double().view((-1, 1) + trail), out.index_select(0, y0),
                        out.index_select(0, y1))
    return np.ascontiguousarray(out.numpy())


def _resize_linear_u16(image: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(image, (w, h))`` of a uint16 image, bit for bit:
    OpenCV resizes 16-bit images in float32 (:func:`_resize_linear_f32`)
    and rounds half to even with saturation."""
    out = _resize_linear_f32(image.astype(np.float32), w, h)
    return np.ascontiguousarray(np.clip(np.rint(out), 0, 65535).astype(np.uint16))


def warp_affine(image: np.ndarray, matrix: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(image, matrix, size_wh, flags=INTER_LINEAR)`` with
    ``BORDER_CONSTANT`` 0: output pixel (x, y) is the bilinear sample of
    ``image`` at ``M^-1 (x, y, 1)``, corners outside the image counting 0.
    One ``F.grid_sample`` in float64: a float32 grid would round the
    source coordinates, which OpenCV keeps exact for float warps."""
    w, h = int(size_wh[0]), int(size_wh[1])
    m = np.concatenate([np.asarray(matrix, np.float64).reshape(2, 3), [[0.0, 0.0, 1.0]]])
    inv = np.linalg.inv(m)[:2]
    hs, ws = image.shape[:2]
    xs, ys = np.arange(w, dtype=np.float64)[None], np.arange(h, dtype=np.float64)[:, None]
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    # pixel centres to grid_sample's [-1, 1] (align_corners=False)
    grid = torch.from_numpy(np.stack([(2 * sx + 1) / ws - 1, (2 * sy + 1) / hs - 1], axis=-1))
    out = F.grid_sample(_as_float_chw(image).double(), grid[None], mode='bilinear',
                        padding_mode='zeros', align_corners=False)
    return _back(out.float(), image)


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2HSV)`` of a float32 [H, W, 3] image:
    H in degrees [0, 360), S = (V - min) / V, V = max."""
    x = np.asarray(image, np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + FLT_EPSILON)
    diff = np.float32(60.0) / (diff + FLT_EPSILON)
    h = np.where(v == r, (g - b) * diff,
                 np.where(v == g, (b - r) * diff + np.float32(120.0),
                          (r - g) * diff + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


# per sector of the hue: which of (v, v(1-s), v(1-sh), v(1-s(1-h))) is
# (b, g, r), OpenCV's table
_SECTOR_BGR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_HSV2RGB)`` of a float32 [H, W, 3] image
    with H in degrees."""
    x = np.asarray(image, np.float32)
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    h = h * np.float32(6.0 / 360.0)
    h = np.fmod(h, np.float32(6.0))
    h = np.where(h < 0, h + np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0.0), h).astype(np.float32)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], axis=-1)
    idx = _SECTOR_BGR[sector]  # [H, W, 3] in (b, g, r) order
    bgr = np.take_along_axis(tab, idx, axis=-1)
    rgb = bgr[..., ::-1]
    gray = (s == 0)[..., None]
    return np.ascontiguousarray(np.where(gray, v[..., None], rgb).astype(np.float32))


# OpenCV's RGB -> grey weights for 8-bit images, 0.299 / 0.587 / 0.114 in
# 15-bit fixed point (equal to cv2.cvtColor at all 2^24 RGB triples; the
# 14-bit weights 4899 / 9617 / 1868 differ from it where the sum is near .5)
GRAY_R, GRAY_G, GRAY_B, GRAY_SHIFT = 9798, 19235, 3735, 15


def rgb_to_gray(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2GRAY)`` of a uint8 [H, W, 3] RGB
    image, bit for bit: ``(R*9798 + G*19235 + B*3735 + 2^14) >> 15``."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f'rgb_to_gray: expected uint8 [H, W, 3], got {image.dtype} '
                         f'{image.shape}')
    x = image.astype(np.int32)
    g = (x[..., 0] * GRAY_R + x[..., 1] * GRAY_G + x[..., 2] * GRAY_B
         + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    return g.astype(np.uint8)
