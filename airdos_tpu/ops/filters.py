"""Basic image filters in XLA.

Covers the reference's OpenCV filter usage: GaussianBlur(7,7,sigma=2) before
descriptor extraction (ORBextractor.cc:1105), 10x10 erosion of segmentation
masks for the mask pyramid (ORBextractor.cc:1121-1156), and bilinear resize
for pyramid levels.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _conv2d_same(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """2-D correlation with SAME (replicate-free, zero) padding.
    img [H, W] float32, kernel [kh, kw]."""
    x = img[None, None]
    k = kernel[None, None]
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return out[0, 0]


def _conv2d_same_reflect(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """SAME conv with reflect padding (matches cv2.BORDER_REFLECT_101)."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    padded = jnp.pad(img, ((ph, ph), (pw, pw)), mode="reflect")
    x = padded[None, None]
    k = kernel[None, None]
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return out[0, 0]


@functools.lru_cache(maxsize=8)
def _gauss_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur7(img: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """Separable 7x7 Gaussian blur, BORDER_REFLECT_101 like the reference's
    cv::GaussianBlur(image, 7, 7, 2, 2, BORDER_REFLECT_101).

    Implemented as shift-and-add (7 fused multiply-adds per axis) instead
    of a single-channel lax.conv."""
    k = _gauss_kernel1d(7, sigma)
    h, w = img.shape
    p = jnp.pad(img, ((0, 0), (3, 3)), mode="reflect")
    out = k[0] * p[:, 0:w]
    for i in range(1, 7):
        out = out + k[i] * p[:, i:i + w]
    p = jnp.pad(out, ((3, 3), (0, 0)), mode="reflect")
    out = k[0] * p[0:h, :]
    for i in range(1, 7):
        out = out + k[i] * p[i:i + h, :]
    return out


def erode(mask: jnp.ndarray, ksize: int = 10) -> jnp.ndarray:
    """Binary erosion with a ksize x ksize rectangle (cv2.erode semantics:
    output 1 only if every pixel under the kernel is 1; border treated as 1
    to match cv2's default replicated border for erosion).

    mask: [H, W] float32/bool with 1 = keep (static), 0 = masked out.
    """
    m = mask.astype(jnp.float32)
    # cv2 anchors a k x k kernel at (k//2, k//2); reduce_window with explicit
    # asymmetric padding reproduces that for even sizes.
    lo = ksize // 2
    hi = ksize - 1 - lo
    out = jax.lax.reduce_window(
        m, 1.0, jax.lax.min, (ksize, ksize), (1, 1),
        padding=((lo, hi), (lo, hi)))
    return out


def dilate(mask: jnp.ndarray, ksize: int = 3) -> jnp.ndarray:
    m = mask.astype(jnp.float32)
    lo = ksize // 2
    hi = ksize - 1 - lo
    return jax.lax.reduce_window(
        m, 0.0, jax.lax.max, (ksize, ksize), (1, 1),
        padding=((lo, hi), (lo, hi)))


def max_pool_same(x: jnp.ndarray, ksize: int = 3) -> jnp.ndarray:
    """ksize x ksize max filter with SAME extent (for NMS)."""
    lo = ksize // 2
    hi = ksize - 1 - lo
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (ksize, ksize), (1, 1),
        padding=((lo, hi), (lo, hi)))


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear resize matching cv2.resize(..., INTER_LINEAR) pixel-centre
    alignment: src = (dst + 0.5) * scale - 0.5."""
    h, w = img.shape
    sy = h / out_h
    sx = w / out_w
    ys = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * sy - 0.5
    xs = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * sx - 0.5
    ys = jnp.clip(ys, 0.0, h - 1.0)
    xs = jnp.clip(xs, 0.0, w - 1.0)
    y0 = jnp.floor(ys).astype(jnp.int32)
    x0 = jnp.floor(xs).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    # gather 4 corners via two-stage row/col indexing (XLA lowers to gathers)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy
