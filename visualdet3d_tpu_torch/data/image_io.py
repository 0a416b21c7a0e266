"""PNG reading and writing on ``zlib`` and numpy (the counterpart of
``kittidata.read_image``, which reads through PIL, and of the JAX package's
``cv2.imread(path, -1)`` / ``cv2.imwrite`` of 16-bit disparity maps).

Reads non-interlaced PNGs of 8-bit gray, RGB and RGBA and 16-bit gray,
with any of the five row filters; anything else raises. The unfilter is a
small C function (``csrc/png_unfilter.c``) built with the host C compiler
at first use and called through ``ctypes``, which releases the interpreter
lock, so the data loader's threads decode in parallel; without a compiler
it raises. :func:`unfilter_plain` is the numpy version the tests hold it
against. Writes 8-bit RGB and 16-bit gray, each row with the filter type
that ``filters`` gives it.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Sequence

import numpy as np

from visualdet3d_tpu_torch.ops import kernel_build

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PNG colour type -> channels, for the types this reader takes
_CHANNELS = {0: 1, 2: 3, 6: 4}
FILTER_TYPES = (0, 1, 2, 3, 4)  # None, Sub, Up, Average, Paeth


def _unfilter_fn():
    fn = kernel_build.load_host('png_unfilter').vd3d_png_unfilter
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64)
    fn.restype = ctypes.c_int
    return fn


def unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The unfiltered bytes [height, rowbytes] of ``raw`` (the inflated
    IDAT stream: each row one filter-type byte, then ``rowbytes`` bytes),
    by the C function."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (rowbytes + 1):
        raise ValueError(f'PNG data holds {raw.size} bytes, not {height} rows of '
                         f'1 + {rowbytes}')
    out = np.empty((height, rowbytes), np.uint8)
    bad = _unfilter_fn()(raw.ctypes.data, out.ctypes.data, height, rowbytes, bpp)
    if bad:
        raise ValueError(f'PNG row {bad - 1}: unknown filter type '
                         f'{raw.reshape(-1)[(bad - 1) * (rowbytes + 1)]}')
    return out


def unfilter_plain(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """:func:`unfilter` in numpy: Sub as a cumulative sum mod 256 over
    pixels, Up as an add, Average and Paeth pixel by pixel."""
    rows = np.asarray(raw, np.uint8).reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.uint8)
    for r in range(height):
        ftype, line = int(rows[r, 0]), rows[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur = np.zeros(rowbytes, np.uint8)
            up = prior.astype(np.int32)
            for i in range(0, rowbytes, bpp):
                a = cur[i - bpp:i].astype(np.int32) if i else np.zeros(bpp, np.int32)
                b = up[i:i + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp:i] if i else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[i:i + bpp] = (line[i:i + bpp].astype(np.int32) + pred).astype(np.uint8)
        else:
            raise ValueError(f'PNG row {r}: unknown filter type {ftype}')
        out[r] = cur
        prior = cur
    return out


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError('PNG chunk runs past the end of the file')
        if zlib.crc32(ctype + body) != struct.unpack('>I', crc)[0]:
            raise ValueError(f'PNG chunk {ctype!r}: CRC mismatch')
        yield ctype, body
        if ctype == b'IEND':
            return
        pos += 12 + length
    raise ValueError('PNG without IEND')


def decode_png(data: bytes, plain: bool = False) -> np.ndarray:
    """The image of the PNG ``data``: [H, W] for gray (uint8, or uint16 at
    16 bits), [H, W, 3] RGB or [H, W, 4] RGBA uint8. ``plain``: unfilter
    with :func:`unfilter_plain` (tests)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError('not a PNG file')
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'IDAT':
            idat.append(body)
        elif ctype == b'PLTE':
            raise ValueError('palette PNGs are not supported')
    if header is None:
        raise ValueError('PNG without IHDR')
    width, height, depth, colour, compression, filter_method, interlace = header
    if colour not in _CHANNELS or (depth, colour) not in ((8, 0), (8, 2), (8, 6), (16, 0)):
        raise ValueError(f'unsupported PNG: bit depth {depth}, colour type {colour} '
                         '(8-bit gray, RGB or RGBA, or 16-bit gray)')
    if compression != 0 or filter_method != 0 or interlace != 0:
        raise ValueError(f'unsupported PNG: compression {compression}, filter method '
                         f'{filter_method}, interlace {interlace}')
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    out = (unfilter_plain if plain else unfilter)(raw, height, width * bpp, bpp)
    if depth == 16:
        return out.view('>u2').astype(np.uint16).reshape(height, width)
    return out.reshape((height, width) if channels == 1 else (height, width, channels))


def read_png(path: str) -> np.ndarray:
    """The image of the PNG file at ``path`` (:func:`decode_png`), as
    ``cv2.imread(path, -1)`` gives it, but in RGB(A) channel order."""
    with open(path, 'rb') as f:
        return decode_png(f.read())


def read_image(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3], as PIL's ``Image.open(path).convert('RGB')``:
    gray repeated over the channels, alpha dropped."""
    image = read_png(path)
    if image.dtype != np.uint8:
        raise ValueError(f'{path}: a 16-bit PNG is not an RGB image')
    if image.ndim == 2:
        return np.repeat(image[:, :, None], 3, axis=2)
    return np.ascontiguousarray(image[:, :, :3])


def _filter_rows(image_bytes: np.ndarray, bpp: int, filters: Sequence[int]) -> np.ndarray:
    """The filtered rows [H, 1 + rowbytes] of the unfiltered bytes
    ``image_bytes`` [H, rowbytes]: row r takes filter type
    ``filters[r % len(filters)]``. Vectorised: the predictors read the
    unfiltered bytes, which are all known. With type 0 on every row the
    bytes are copied as they are (no predictor is formed)."""
    h, n = image_bytes.shape
    if all(f == 0 for f in filters):
        out = np.empty((h, n + 1), np.uint8)
        out[:, 0] = 0
        out[:, 1:] = image_bytes
        return out
    x = image_bytes.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    types = np.array([filters[r % len(filters)] for r in range(h)], np.int64)
    if not np.isin(types, FILTER_TYPES).all():
        raise ValueError(f'filter types are 0-4, got {sorted(set(types.tolist()))}')
    pred = np.choose(types[:, None], preds)
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = types
    out[:, 1:] = (x - pred).astype(np.uint8)
    return out


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack('>I', len(body)) + ctype + body + struct.pack(
        '>I', zlib.crc32(ctype + body))


def encode_png(image: np.ndarray, filters: Sequence[int] = (0,)) -> bytes:
    """PNG bytes of an 8-bit RGB [H, W, 3] or 16-bit gray [H, W] image,
    row r filtered with ``filters[r % len(filters)]``."""
    image = np.asarray(image)
    if image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        depth, colour, bpp = 8, 2, 3
        rows = image.reshape(image.shape[0], -1)
    elif image.dtype == np.uint16 and image.ndim == 2:
        depth, colour, bpp = 16, 0, 2
        rows = image.astype('>u2').view(np.uint8).reshape(image.shape[0], -1)
    else:
        raise ValueError(f'write 8-bit RGB [H, W, 3] or 16-bit gray [H, W], got '
                         f'{image.dtype} {image.shape}')
    height, width = image.shape[:2]
    header = struct.pack('>IIBBBBB', width, height, depth, colour, 0, 0, 0)
    data = zlib.compress(_filter_rows(rows, bpp, filters).tobytes())
    return PNG_SIGNATURE + _chunk(b'IHDR', header) + _chunk(b'IDAT', data) + _chunk(b'IEND', b'')


def write_png(path: str, image: np.ndarray, filters: Sequence[int] = (0,)) -> None:
    """Write :func:`encode_png` of ``image`` to ``path``."""
    with open(path, 'wb') as f:
        f.write(encode_png(image, filters))
