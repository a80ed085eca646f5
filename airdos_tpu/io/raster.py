"""Filled circles and thick lines in numpy, pixel-for-pixel as OpenCV draws
them (``cv2.circle(img, c, r, v, -1)`` and ``cv2.line(img, p1, p2, v, t)``
with the default 8-connected line type and integer coordinates).

The synthetic world draws its landmark dots and human limbs with these, so
scene generation needs nothing beyond numpy.  Every routine follows the
integer arithmetic of OpenCV's imgproc/src/drawing.cpp (``Circle``,
``ThickLine``, ``FillConvexPoly``, ``Line2``, ``LineIterator``,
``clipLine``); tests/test_raster.py compares them with cv2 where it is
installed.
"""
from __future__ import annotations

import functools
import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img, y: int, x1: int, x2: int, value) -> None:
    """Span [x1, x2] of row y, clipped to the image."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = value


def _put(img, x: int, y: int, value) -> None:
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = value


# ------------------------------------------------------------------ circles
@functools.lru_cache(maxsize=64)
def _circle_halfwidths(radius: int) -> tuple:
    """Half-width of the filled span at each row offset 0..radius, from the
    midpoint walk of OpenCV's ``Circle``."""
    hw = [0] * (radius + 1)
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        hw[dy] = max(hw[dy], dx)
        hw[dx] = max(hw[dx], dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return tuple(hw)


@functools.lru_cache(maxsize=64)
def _circle_stencil(radius: int) -> np.ndarray:
    hw = _circle_halfwidths(radius)
    off = np.arange(-radius, radius + 1)
    half = np.asarray(hw)[np.abs(off)]
    return np.abs(off)[None, :] <= half[:, None]


def fill_circle(img: np.ndarray, center, radius: int, value) -> None:
    """``cv2.circle(img, center, radius, value, -1)`` in place."""
    cx, cy = int(center[0]), int(center[1])
    r = int(radius)
    if r < 0:
        raise ValueError(f"radius must be >= 0, got {r}")
    h, w = img.shape[:2]
    y0, y1 = max(cy - r, 0), min(cy + r + 1, h)
    x0, x1 = max(cx - r, 0), min(cx + r + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    st = _circle_stencil(r)[y0 - (cy - r):y1 - (cy - r),
                            x0 - (cx - r):x1 - (cx - r)]
    img[y0:y1, x0:x1][st] = value


# -------------------------------------------------------------------- lines
def _clip_line(w: int, h: int, p1, p2):
    """OpenCV ``clipLine`` on [0, w) x [0, h); None if nothing is left."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
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
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line8(img, p1, p2, value) -> None:
    """One-pixel 8-connected line (OpenCV ``Line`` via ``LineIterator``)."""
    h, w = img.shape[:2]
    clipped = _clip_line(w, h, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:                                  # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x1, y1
    xs = np.empty(major + 1, np.int64)
    ys = np.empty(major + 1, np.int64)
    for i in range(major + 1):
        xs[i], ys[i] = x, y
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if steep:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0
    img[ys, xs] = value


def _line2(img, p1, p2, value) -> None:
    """Fixed-point (16-bit fraction) edge line of OpenCV ``Line2``."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = XY_ONE
        y_step = _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _tdiv(dx << XY_SHIFT, ay | 1)
        y_step = XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT,
         (y2 + (XY_ONE >> 1)) >> XY_SHIFT, value)
    if ecount < 0:
        return
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * y_step) >> XY_SHIFT
    else:
        xs = (x1 + k * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + k
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = value


def _fill_convex_poly(img, v, value) -> None:
    """OpenCV ``FillConvexPoly`` for 8-connected edges with vertices in
    16-bit fixed point (shift == XY_SHIFT)."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    imin = 0
    ymin = ymax = v[0][1]
    xmin = xmax = v[0][0]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin = p[1]
            imin = i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(img, p0, p, value)
        p0 = p
    xmin = (xmin + delta) >> XY_SHIFT
    xmax = (xmax + delta) >> XY_SHIFT
    ymin = (ymin + delta) >> XY_SHIFT
    ymax = (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per side: current vertex index, walk direction, x, dx, end row
    idx = [imin, imin]
    di = [1, npts - 1]
    ex = [-XY_ONE, -XY_ONE]
    edx = [0, 0]
    ye = [ymin, ymin]
    edges = npts
    y = ymin
    while True:
        for i in range(2):
            if y >= ye[i]:
                idx0 = idx[i]
                j = idx0 + di[i]
                if j >= npts:
                    j -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[j][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs_, xe_ = v[idx0][0], v[j][0]
                        ye[i] = ty
                        edx[i] = _tdiv((xe_ - xs_) * 2 + (ty - y),
                                       2 * (ty - y))
                        ex[i] = xs_
                        idx[i] = j
                        break
                    idx0 = j
                    j += di[i]
                    if j >= npts:
                        j -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            _hline(img, y, (ex[left] + delta) >> XY_SHIFT,
                   (ex[right] + delta) >> XY_SHIFT, value)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def draw_line(img: np.ndarray, p1, p2, value, thickness: int = 1) -> None:
    """``cv2.line(img, p1, p2, value, thickness)`` in place (integer end
    points, 8-connected)."""
    t = int(thickness)
    if not 0 < t <= 32767:
        raise ValueError(f"thickness must be in [1, 32767], got {t}")
    x0, y0 = int(p1[0]), int(p1[1])
    x1, y1 = int(p2[0]), int(p2[1])
    if t == 1:
        _line8(img, (x0, y0), (x1, y1), value)
        return
    # cv::line first clips a thick line to the image grown by the thickness
    h, w = img.shape[:2]
    clipped = _clip_line(w + 2 * t, h + 2 * t, (x0 + t, y0 + t),
                         (x1 + t, y1 + t))
    if clipped is None:
        return
    (x0, y0), (x1, y1) = ((x - t, y - t) for x, y in clipped)
    p0 = (x0 << XY_SHIFT, y0 << XY_SHIFT)
    q0 = (x1 << XY_SHIFT, y1 << XY_SHIFT)
    fdx = (p0[0] - q0[0]) / XY_ONE
    fdy = (q0[1] - p0[1]) / XY_ONE
    r2 = fdx * fdx + fdy * fdy
    odd = t & 1
    tfix = t << (XY_SHIFT - 1)
    if abs(r2) > np.finfo(np.float64).eps:
        r = (tfix + odd * XY_ONE * 0.5) / math.sqrt(r2)
        dpx = int(round(fdy * r))
        dpy = int(round(fdx * r))
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy),
                                (p0[0] - dpx, p0[1] - dpy),
                                (q0[0] - dpx, q0[1] - dpy),
                                (q0[0] + dpx, q0[1] + dpy)], value)
    cap = (tfix + (XY_ONE >> 1)) >> XY_SHIFT
    for (x, y) in ((x0, y0), (x1, y1)):
        fill_circle(img, (x, y), cap, value)
