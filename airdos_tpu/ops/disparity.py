"""Dense stereo disparity (SGBM-lite) for human-pose association guidance.

The reference runs cv::StereoSGBM (48 disparities, SAD window 11,
uniqueness 15) once per frame purely to guide left<->right human-pose
association (src/Frame.cc:313-416).  Rebuild: a block-matching cost
volume — per-disparity absolute difference box-filtered 11x11, argmin with a
uniqueness-ratio check — fully vectorized and fused by XLA.  Behavioral, not bitwise, parity: downstream use is
only a +-30 px association gate.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _box_filter(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """[..., H, W] box sum over k x k windows (SAME)."""
    lo = k // 2
    hi = k - 1 - lo
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1,) * (x.ndim - 2) + (k, k),
        (1,) * x.ndim,
        padding=((0, 0),) * (x.ndim - 2) + ((lo, hi), (lo, hi)))


def patch_disparity(im_left: jnp.ndarray, im_right: jnp.ndarray,
                    px: jnp.ndarray, num_disp: int = 48,
                    block: int = 11) -> jnp.ndarray:
    """Disparity at given left-image pixels only.

    The reference computes a FULL-image SGBM map (src/Frame.cc:323-336)
    and then reads it at ~5 torso-joint pixels per human for left/right
    association guidance.  Replacement: SAD block matching at
    exactly the requested pixels — a [N, D, B, B] gather instead of a
    [D, H, W] cost volume (~5000x less compute and a N-float instead of
    H*W-float device->host transfer).

    px: [N, 2] float32 (u, v) left-image pixel coords.
    Returns [N] float32 disparity; -1 where invalid.
    """
    h, w = im_left.shape
    half = block // 2
    u = jnp.round(px[:, 0]).astype(jnp.int32)
    v = jnp.round(px[:, 1]).astype(jnp.int32)
    inb_px = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    off = jnp.arange(-half, half + 1)
    yy = jnp.clip(v[:, None] + off[None, :], 0, h - 1)        # [N, B]
    xxL = jnp.clip(u[:, None] + off[None, :], 0, w - 1)       # [N, B]
    patchL = im_left[yy[:, :, None], xxL[:, None, :]]         # [N, B, B]
    d = jnp.arange(num_disp)
    xxR = u[:, None, None] - d[None, :, None] + off[None, None, :]  # [N, D, B]
    covered = xxR >= 0
    xxRc = jnp.clip(xxR, 0, w - 1)
    patchR = im_right[yy[:, None, :, None], xxRc[:, :, None, :]]  # [N, D, B, B]
    sad = jnp.sum(jnp.abs(patchL[:, None] - patchR), axis=(-2, -1))  # [N, D]
    sad = sad + jnp.where(jnp.all(covered, axis=-1), 0.0, 1e8)
    best = jnp.argmin(sad, axis=1)
    # sub-pixel parabola
    bm1 = jnp.clip(best - 1, 0, num_disp - 1)
    bp1 = jnp.clip(best + 1, 0, num_disp - 1)
    take = lambda idx: jnp.take_along_axis(sad, idx[:, None], axis=1)[:, 0]
    c_m, c_0, c_p = take(bm1), take(best), take(bp1)
    denom = c_m + c_p - 2.0 * c_0
    delta = jnp.where(jnp.abs(denom) > 1e-6,
                      0.5 * (c_m - c_p)
                      / jnp.where(jnp.abs(denom) > 1e-6, denom, 1.0),
                      0.0)
    disp = best.astype(jnp.float32) + jnp.clip(delta, -0.5, 0.5)
    valid = inb_px & (best > 0) & (best < num_disp - 1) & (c_0 < 1e7)
    return jnp.where(valid, disp, -1.0)


def disparity_bm(im_left: jnp.ndarray, im_right: jnp.ndarray,
                 num_disp: int = 48, block: int = 11,
                 uniqueness: float = 0.15) -> jnp.ndarray:
    """Left-image disparity map [H, W] float32; invalid pixels -> -1.

    Disparity d means im_left[y, x] ~ im_right[y, x - d].
    """
    h, w = im_left.shape
    # cost volume: shift right image rightwards by d
    costs = []
    for d in range(num_disp):
        shifted = jnp.pad(im_right, ((0, 0), (d, 0)))[:, :w]
        ad = jnp.abs(im_left - shifted)
        # invalidate the uncovered left band
        ad = ad.at[:, :d].set(1e6 / max(block * block, 1))
        costs.append(ad)
    vol = jnp.stack(costs, axis=0)                      # [D, H, W]
    vol = _box_filter(vol, block)

    best = jnp.argmin(vol, axis=0)                      # [H, W]
    cmin = jnp.min(vol, axis=0)
    # uniqueness: second-best (excluding +-1 neighbours of best) must be
    # sufficiently worse
    d_idx = jax.lax.broadcasted_iota(jnp.int32, vol.shape, 0)
    near = jnp.abs(d_idx - best[None]) <= 1
    vol2 = jnp.where(near, jnp.inf, vol)
    c2 = jnp.min(vol2, axis=0)
    unique_ok = cmin * (1.0 + uniqueness) <= c2

    # sub-pixel parabola
    bm1 = jnp.clip(best - 1, 0, num_disp - 1)
    bp1 = jnp.clip(best + 1, 0, num_disp - 1)
    take = lambda idx: jnp.take_along_axis(vol, idx[None], axis=0)[0]
    c_m, c_0, c_p = take(bm1), take(best), take(bp1)
    denom = c_m + c_p - 2.0 * c_0
    delta = jnp.where(jnp.abs(denom) > 1e-6,
                      0.5 * (c_m - c_p) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1.0),
                      0.0)
    disp = best.astype(jnp.float32) + jnp.clip(delta, -0.5, 0.5)

    valid = unique_ok & (best > 0) & (best < num_disp - 1)
    return jnp.where(valid, disp, -1.0)
