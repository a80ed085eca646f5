"""Plain numpy references for the front-end device ops.

Written independently of the jitted ops, in exact integers or float64:
tests compare the ops with them on the CPU, and chip_smoke.py compares
them on the GPU at the deployment's widths.
"""
from __future__ import annotations

import numpy as np

from airdos_tpu.ops.brief import load_pattern
from airdos_tpu.ops.orientation import HALF_PATCH, _umax

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def hamming_matrix(a: np.ndarray, b: np.ndarray,
                   rows_per_chunk: int = 256) -> np.ndarray:
    """All-pairs Hamming distances of packed descriptors.
    a: uint32 [N, 8], b: uint32 [M, 8].  Returns int32 [N, M]."""
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    out = np.empty((a.shape[0], b.shape[0]), np.int32)
    for lo in range(0, a.shape[0], rows_per_chunk):
        x = a[lo:lo + rows_per_chunk, None, :] ^ b[None, :, :]
        out[lo:lo + rows_per_chunk] = _POPCOUNT8[
            x.view(np.uint8)].sum(axis=-1)
    return out


def ic_angles(img: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Intensity-centroid angles in degrees [0, 360) over the circular
    31x31 patch (ORBextractor.cc IC_Angle), in float64."""
    img = np.asarray(img, np.float64)
    umax = _umax()
    m10 = np.zeros(len(xs))
    m01 = np.zeros(len(xs))
    xs = np.asarray(xs, np.int64)
    ys = np.asarray(ys, np.int64)
    for dy in range(-HALF_PATCH, HALF_PATCH + 1):
        u = int(umax[abs(dy)])
        dx = np.arange(-u, u + 1)
        row = img[ys[:, None] + dy, xs[:, None] + dx[None, :]]
        m10 += (row * dx[None, :]).sum(axis=1)
        m01 += dy * row.sum(axis=1)
    return np.degrees(np.arctan2(m01, m10)) % 360.0


def brief_descriptors(img_blur: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                      angles_deg: np.ndarray, tie_tol: float = 1e-5):
    """rBRIEF descriptors from a blurred level image.

    Returns (desc uint8 [N, 32], near_tie bool [N]).  ``near_tie`` marks
    keypoints with a rotated sample offset within ``tie_tol`` of a
    rounding boundary, where float32 and float64 trigonometry may round
    the offset to different pixels."""
    pat = load_pattern().astype(np.float64)
    px = np.concatenate([pat[:, 0], pat[:, 2]])
    py = np.concatenate([pat[:, 1], pat[:, 3]])
    ang = np.radians(np.asarray(angles_deg, np.float64))
    ca, sa = np.cos(ang)[:, None], np.sin(ang)[:, None]
    fx = px[None] * ca - py[None] * sa
    fy = px[None] * sa + py[None] * ca
    frac = np.concatenate([fx - np.floor(fx), fy - np.floor(fy)], axis=1)
    near_tie = (np.abs(frac - 0.5) < tie_tol).any(axis=1)
    h, w = img_blur.shape
    gx = np.clip(np.asarray(xs)[:, None] + np.rint(fx).astype(np.int64),
                 0, w - 1)
    gy = np.clip(np.asarray(ys)[:, None] + np.rint(fy).astype(np.int64),
                 0, h - 1)
    vals = np.asarray(img_blur)[gy, gx]
    bits = (vals[:, :256] < vals[:, 256:]).astype(np.uint8)
    desc = np.packbits(bits.reshape(-1, 32, 8), axis=-1,
                       bitorder="little")[..., 0]
    return desc, near_tie


def sad_windows(pyr_l: np.ndarray, pyr_r: np.ndarray, oct_l: np.ndarray,
                gy: np.ndarray, gxl: np.ndarray, gxr: np.ndarray):
    """Left [N, 11, 11] patches and right [N, 11, 21] strips of the stereo
    SAD search, read pixel by pixel from each keypoint's pyramid level."""
    n = len(oct_l)
    patch = np.empty((n, gy.shape[1], gxl.shape[1]), pyr_l.dtype)
    strip = np.empty((n, gy.shape[1], gxr.shape[1]), pyr_r.dtype)
    for k in range(n):
        lvl = int(oct_l[k])
        patch[k] = pyr_l[lvl][np.ix_(gy[k], gxl[k])]
        strip[k] = pyr_r[lvl][np.ix_(gy[k], gxr[k])]
    return patch, strip
