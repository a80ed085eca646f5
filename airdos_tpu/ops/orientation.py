"""Intensity-centroid keypoint orientation (rBRIEF's IC angle).

The reference computes per-keypoint circular-patch moments with hand-rolled
row loops (ORBextractor.cc IC_Angle, 78-105).  Here the patch moments m10
and m01 are contractions of each keypoint's gathered 31x31 patch with fixed
weight kernels (dx and dy over the circular patch) — no per-keypoint loops.
The same kernels as dense convolutions give whole-image moment maps
(``ic_angle_maps``), which tests use as an oracle.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH = 15  # reference: HALF_PATCH_SIZE (ORBextractor.cc:74)


@functools.lru_cache(maxsize=1)
def _umax() -> np.ndarray:
    """Per-row circular patch half-width, exactly as the reference builds it
    (ORBextractor.cc:456-471): symmetric Bresenham circle of radius 15."""
    umax = np.zeros(HALF_PATCH + 2, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:HALF_PATCH + 1]


@functools.lru_cache(maxsize=1)
def _moment_kernels() -> tuple:
    """31x31 kernels K10[dy, dx] = dx, K01[dy, dx] = dy over the circular
    patch |dx| <= umax[|dy|]."""
    umax = _umax()
    size = 2 * HALF_PATCH + 1
    k10 = np.zeros((size, size), np.float32)
    k01 = np.zeros((size, size), np.float32)
    for dy in range(-HALF_PATCH, HALF_PATCH + 1):
        u = umax[abs(dy)]
        for dx in range(-u, u + 1):
            k10[dy + HALF_PATCH, dx + HALF_PATCH] = dx
            k01[dy + HALF_PATCH, dx + HALF_PATCH] = dy
    return k10, k01


def ic_angle_maps(img: jnp.ndarray) -> tuple:
    """Dense moment maps (m10, m01), each [H, W] float32.
    out[y, x] = sum over circular patch of weight * img[y+dy, x+dx].

    Computes every pixel; ``keypoint_angles`` touches only the patches at
    the keypoints and is the one the extractor uses."""
    k10, k01 = _moment_kernels()
    k = jnp.stack([jnp.asarray(k10), jnp.asarray(k01)])[:, None]   # [2,1,31,31]
    x = img[None, None]
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return out[0, 0], out[0, 1]


def sample_angles(m10_map: jnp.ndarray, m01_map: jnp.ndarray,
                  xs: jnp.ndarray, ys: jnp.ndarray) -> jnp.ndarray:
    """Gather angles (degrees, [0, 360) like cv::fastAtan2) at integer
    keypoint coords.  xs, ys: [N] int32."""
    m10 = m10_map[ys, xs]
    m01 = m01_map[ys, xs]
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    return jnp.where(ang < 0, ang + 360.0, ang)


def keypoint_angles(img: jnp.ndarray, xs: jnp.ndarray,
                    ys: jnp.ndarray) -> jnp.ndarray:
    """IC angles computed only at keypoints.

    Keypoints are guaranteed >= MIN_BORDER=16 > HALF_PATCH from the image
    edge by the extractor; padded slots (xs=ys=0) produce garbage angles
    that are masked by the validity flags downstream.  Each 31x31 patch is
    gathered and contracted with the moment kernels."""
    k10, k01 = _moment_kernels()
    h, w = img.shape
    dy = jnp.arange(-HALF_PATCH, HALF_PATCH + 1)
    gy = jnp.clip(ys[:, None] + dy[None, :], 0, h - 1)           # [N, 31]
    gx = jnp.clip(xs[:, None] + dy[None, :], 0, w - 1)           # [N, 31]
    patch = img[gy[:, :, None], gx[:, None, :]]                  # [N, 31, 31]
    # both kernels sum to zero, so removing each patch's mean leaves the
    # moments unchanged while keeping the float32 contraction from
    # cancelling large sums (25x smaller angle error vs float64)
    patch = patch - jnp.mean(patch, axis=(1, 2), keepdims=True)
    kk = jnp.stack([jnp.asarray(k10), jnp.asarray(k01)])         # [2, 31, 31]
    m = jnp.einsum("nij,kij->nk", patch, kk)                     # [N, 2]
    ang = jnp.degrees(jnp.arctan2(m[:, 1], m[:, 0]))
    return jnp.where(ang < 0, ang + 360.0, ang)
