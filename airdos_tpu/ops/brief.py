"""Steered-BRIEF (rBRIEF) 256-bit descriptors.

Uses the standard learned ORB sampling pattern (the public 256-pair
``bit_pattern_31`` constant from the ORB paper / OpenCV, stored as
orb_pattern.npy) so descriptors are bit-compatible with the reference's
computeOrbDescriptor (ORBextractor.cc:109-148) and with cv2.ORB.

Batched formulation: rotate all 512 pattern points for all N keypoints at
once, gather the blurred level image at the N x 512 sample locations,
compare the 256 pairs, and pack bits — one fused gather + compare + pack,
no loops.
"""
from __future__ import annotations

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=1)
def load_pattern() -> np.ndarray:
    """[256, 4] int32: (x0, y0, x1, y1) per descriptor bit."""
    return np.load(Path(__file__).parent / "orb_pattern.npy")


def compute_descriptors(img_blur: jnp.ndarray,
                        xs: jnp.ndarray, ys: jnp.ndarray,
                        angles_deg: jnp.ndarray) -> jnp.ndarray:
    """Compute 256-bit descriptors.

    img_blur: [H, W] float32 — the 7x7/sigma=2 blurred level image.
    xs, ys:   [N] int32 keypoint coords at this level.
    angles_deg: [N] float32 orientation.
    Returns uint8 [N, 32] (cv2-compatible byte layout).
    """
    pat = jnp.asarray(load_pattern())              # [256, 4]
    px = jnp.concatenate([pat[:, 0], pat[:, 2]])   # [512] sample-point xs
    py = jnp.concatenate([pat[:, 1], pat[:, 3]])   # [512]

    ang = jnp.radians(angles_deg)
    ca, sa = jnp.cos(ang), jnp.sin(ang)            # [N]
    # Rotated integer offsets, cvRound = round-half-to-even == jnp.round.
    dx = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None]).astype(jnp.int32)
    dy = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None]).astype(jnp.int32)

    # gather the N x 512 rotated samples, clipped to the image edge
    h, w = img_blur.shape
    gx = jnp.clip(xs[:, None] + dx, 0, w - 1)      # [N, 512]
    gy = jnp.clip(ys[:, None] + dy, 0, h - 1)
    vals = img_blur[gy, gx]                        # [N, 512]

    t0 = vals[:, :256]
    t1 = vals[:, 256:]
    bits = (t0 < t1).astype(jnp.uint8)             # [N, 256]

    # pack: byte j, bit k from pair 8j + k  (bit value << k)
    bits = bits.reshape(-1, 32, 8)
    shifts = jnp.asarray([1 << k for k in range(8)], jnp.uint8)
    return jnp.sum(bits * shifts[None, None, :], axis=-1).astype(jnp.uint8)


def pack_u32(desc_u8: jnp.ndarray) -> jnp.ndarray:
    """uint8 [N, 32] -> uint32 [N, 8] (little-endian) for popcount matching."""
    d = desc_u8.astype(jnp.uint32).reshape(-1, 8, 4)
    return (d[:, :, 0] | (d[:, :, 1] << 8) | (d[:, :, 2] << 16) | (d[:, :, 3] << 24))
