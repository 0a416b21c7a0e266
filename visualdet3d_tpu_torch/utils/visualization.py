"""Drawing on uint8 images without OpenCV (counterpart of
``visualdet3d_tpu/utils/visualization.py``, which draws with ``cv2.line``).

:func:`line` and :func:`draw_rectangle` reproduce ``cv2.line`` and
``cv2.rectangle`` with ``lineType=LINE_8`` and no ``shift``, pixel for
pixel, in OpenCV's own integer arithmetic:

* thickness 1: the 8-connected line of the two points after clipping to
  the image (OpenCV's ``clipLine``), walked from the left end, one pixel a
  step of the major axis and a step of the minor one where the error term
  goes negative;
* thicker: the segment clipped to the image grown by the thickness, then
  the quadrilateral around it, its corners at 16
  fractional bits, filled scanline by scanline (OpenCV's
  ``FillConvexPoly``, its edges drawn by the fixed-point ``Line2``), and a
  filled disc of radius ``(thickness + 1) // 2`` at the ends (``cv2.line``:
  both ends; ``cv2.rectangle``, a closed polyline: each segment's far end).

:func:`draw_3d_box` is the JAX package's ``draw_3d_box`` on that raster.
Images are [H, W, C] uint8 numpy arrays, drawn in place and returned.
"""
from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _cdiv(a: int, b: int) -> int:
    """C's integer division: truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(width: int, height: int, p1, p2):
    """OpenCV's ``clipLine`` (in int64 arithmetic): the segment clipped to
    [0, width - 1] x [0, height - 1], or None when none of it is inside."""
    if width <= 0 or height <= 0:
        return None
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return ((x1, y1), (x2, y2)) if (c1 | c2) == 0 else None


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line`` at 8-connectivity (``LineIterator``, left to right)."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        clipped = clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        neg = err < 0
        err += -2 * dy + (2 * dx if neg else 0)
        if vert:
            y += sy
            x += sx if neg else 0
        else:
            x += sx
            y += sy if neg else 0


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: the 8-connected line of two points at XY_SHIFT
    fractional bits (the edges of a filled polygon)."""
    h, w = img.shape[:2]
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img: np.ndarray, v, color, shift: int = XY_SHIFT) -> None:
    """OpenCV's ``FillConvexPoly`` at LINE_8 of the points ``v`` at
    ``shift`` fractional bits: the edges, then the scanlines between them."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        p = (p[0] << (XY_SHIFT - shift), p[1] << (XY_SHIFT - shift))
        if shift == 0:
            _line8(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                   (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e['ye']:
                idx0 = e['idx']
                idx = idx0 + e['di']
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e['ye'] = ty
                        e['dx'] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e['x'] = xs
                        e['idx'] = idx
                        break
                    idx0 = idx
                    idx += e['di']
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1  # the C loop's last test decrements past 0
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]['x'] > edge[1]['x'] else (0, 1)
            xx1 = (edge[left]['x'] + delta1) >> XY_SHIFT
            xx2 = (edge[right]['x'] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]['x'] += edge[0]['dx']
        edge[1]['x'] += edge[1]['dx']
        y += 1
        if y > ymax:
            break


def _disc(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's filled ``Circle`` (midpoint walk, horizontal spans)."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for y in (y11, y12):
                _hline(img, y, x11, x12, color)
            for y in (y21, y22):
                _hline(img, y, x21, x22, color)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for y in (y11, y12):
                if 0 <= y < h:
                    _hline(img, y, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for y in (y21, y22):
                    if 0 <= y < h:
                        _hline(img, y, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int, flags: int) -> None:
    """OpenCV's ``ThickLine`` at LINE_8 of two integer points; ``flags`` bit
    0 draws the disc at p0, bit 1 the one at p1."""
    if thickness <= 1:
        _line8(img, p0, p1, color)
        return
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                                (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)], color)
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            center = ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT)
            _disc(img, center, (thickness + (XY_ONE >> 1)) >> XY_SHIFT, color)


def _color(img: np.ndarray, color) -> np.ndarray:
    c = np.clip(np.rint(np.asarray(color, np.float64)), 0, 255).astype(np.uint8)
    return c[:img.shape[2]] if img.ndim == 3 else c[0]


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, thickness)`` at LINE_8. A thick
    line's segment is first clipped to the image grown by ``thickness`` on
    every side, as OpenCV (5.0) clips it: that moves the ends, and so the
    quadrilateral's corners, of a line that leaves the image."""
    p1, p2 = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    thickness = int(thickness)
    if thickness > 1:
        h, w = img.shape[:2]
        m = thickness
        clipped = clip_line(w + 2 * m, h + 2 * m, (p1[0] + m, p1[1] + m), (p2[0] + m, p2[1] + m))
        if clipped is None:
            return img
        (x1, y1), (x2, y2) = clipped
        p1, p2 = (x1 - m, y1 - m), (x2 - m, y2 - m)
    _thick_line(img, p1, p2, _color(img, color), thickness, 3)
    return img


def draw_rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` at LINE_8 (a
    closed polyline through the four corners)."""
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    c = _color(img, color)
    p0 = corners[-1]
    for p in corners:
        _thick_line(img, p0, p, c, int(thickness), 2)
        p0 = p
    return img


def draw_3d_box(img: np.ndarray, corners: np.ndarray, color=(255, 255, 0)) -> np.ndarray:
    """A projected 3D box's wireframe, as the JAX package draws it: the two
    faces' 8 edges at thickness 2, the other 4 at 1.

    corners: [>=2, 8] image coordinates in the CORNER_MATRIX order
    (``geometry.CORNER_MATRIX``), truncated to int32 as the JAX package
    casts them."""
    points = np.array(corners[0:2], dtype=np.int32)
    points = [tuple(int(v) for v in points[:, i]) for i in range(8)]
    for i in range(1, 5):
        line(img, points[i], points[i % 4 + 1], color, 2)
        line(img, points[(i + 4) % 8], points[(i % 4 + 5) % 8], color, 2)
    line(img, points[2], points[7], color)
    line(img, points[3], points[6], color)
    line(img, points[4], points[5], color)
    line(img, points[0], points[1], color)
    return img
