"""Left-right stereo keypoint matching with sub-pixel refinement.

Behavioral rebuild of Frame::ComputeStereoMatches (reference:
src/Frame.cc:829-1003):

1. candidate gating — same row band (|vL - vR| <= 2 * scale[octave_R]),
   octave within +-1, disparity in [0, maxD = bf / baseline],
2. best Hamming match per left keypoint (accept < (TH_HIGH+TH_LOW)/2 = 75),
3. sub-pixel refinement: 11x11 SAD (centre-subtracted L1) slid +-5 px on the
   *unblurred* pyramid images at the left keypoint's level, parabola fit,
4. median-based outlier cut: reject SAD >= 1.5 * 1.4 * median.

Batched redesign: steps 1-2 are one dense masked Hamming matrix instead of
per-row candidate lists; step 3 gathers all windows at once; the whole
thing is a single jit program with static shapes.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from airdos_tpu.ops.hamming import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
TH_ORB = (TH_HIGH + TH_LOW) // 2   # 75
SAD_W = 5                          # half window (11x11)
SAD_L = 5                          # slide range


def stack_pyramid(images: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Pad per-level images into one [L, H0, W0] stack (zeros outside) so a
    traced level index can gather windows from any level."""
    h0, w0 = images[0].shape
    out = []
    for im in images:
        h, w = im.shape
        out.append(jnp.pad(im, ((0, h0 - h), (0, w0 - w))))
    return jnp.stack(out, axis=0)


def sad_windows(pyr_l, pyr_r, oct_l, gy, gxl, gxr):
    """The [N, 11, 11] left patches and [N, 11, 21] right strips of the SAD
    search, gathered from each keypoint's level of the [L, H, W] stacks.
    gy, gxl, gxr: [N, 11] / [N, 11] / [N, 21] in-array coordinates."""
    lvl = oct_l[:, None, None]
    patch_l = pyr_l[lvl, gy[:, :, None], gxl[:, None, :]]        # [N,11,11]
    strip_r = pyr_r[lvl, gy[:, :, None], gxr[:, None, :]]        # [N,11,21]
    return patch_l, strip_r


class StereoMatches(NamedTuple):
    u_right: jnp.ndarray   # [N] float32, -1 if unmatched
    depth: jnp.ndarray     # [N] float32, -1 if unmatched
    best_right: jnp.ndarray  # [N] int32 matched right kp index (-1 invalid)


def stereo_match(xy_l: jnp.ndarray, oct_l: jnp.ndarray, desc_l: jnp.ndarray,
                 valid_l: jnp.ndarray,
                 xy_r: jnp.ndarray, oct_r: jnp.ndarray, desc_r: jnp.ndarray,
                 valid_r: jnp.ndarray,
                 pyr_l: jnp.ndarray, pyr_r: jnp.ndarray,
                 level_widths: jnp.ndarray,
                 scale_factors: jnp.ndarray,
                 bf: jnp.ndarray, baseline: jnp.ndarray) -> StereoMatches:
    """All inputs padded/static.  xy in level-0 coords; pyr_* are [L, H, W]
    stacks from stack_pyramid; level_widths [L] int32 actual widths."""
    uL, vL = xy_l[:, 0], xy_l[:, 1]
    uR, vR = xy_r[:, 0], xy_r[:, 1]
    max_d = bf / baseline

    # ---- gating + Hamming (dense) -----------------------------------
    r_band = 2.0 * scale_factors[oct_r]                      # [M]
    row_ok = jnp.abs(vL[:, None] - vR[None, :]) <= r_band[None, :]
    oct_ok = jnp.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp >= 0.0) & (disp <= max_d)
    ok = row_ok & oct_ok & disp_ok & valid_l[:, None] & valid_r[None, :]

    D = hamming_matrix(desc_l, desc_r)
    D = jnp.where(ok, D, 1 << 10)
    best_r = jnp.argmin(D, axis=1)                           # [N]
    best_dist = jnp.take_along_axis(D, best_r[:, None], axis=1)[:, 0]
    # mutual consistency: the matched right keypoint's own best left
    # keypoint must be this one.  (Not in the reference — its per-row
    # candidate lists rarely alias; our dense form affords the check for
    # one extra argmin, and it kills most repeated-texture mismatches.)
    best_l_of_r = jnp.argmin(D, axis=0)                      # [M]
    mutual = best_l_of_r[best_r] == jnp.arange(xy_l.shape[0])
    # ambiguity rejection: if a second right candidate at a clearly
    # different u is nearly as good, the match (and its disparity) is
    # unreliable — these are exactly the features whose wrong depths later
    # poison keyframe point creation
    far_u = jnp.abs(uR[None, :] - uR[best_r][:, None]) > 1.5
    D2 = jnp.where(far_u, D, 1 << 10)
    second = jnp.min(D2, axis=1)
    unambiguous = best_dist.astype(jnp.float32) < \
        0.9 * jnp.minimum(second, 256).astype(jnp.float32)
    cand_ok = (best_dist < TH_ORB) & mutual & unambiguous

    # ---- sub-pixel SAD ----------------------------------------------
    inv_scale = 1.0 / scale_factors[oct_l]                   # [N]
    su_l = jnp.round(uL * inv_scale).astype(jnp.int32)
    sv_l = jnp.round(vL * inv_scale).astype(jnp.int32)
    uR0 = uR[best_r]
    su_r0 = jnp.round(uR0 * inv_scale).astype(jnp.int32)

    lvl_w = level_widths[oct_l]                              # [N]
    in_bounds = (su_r0 + SAD_L - SAD_W >= 0) & (su_r0 + SAD_L + SAD_W + 1 < lvl_w)

    # clip gather coords to stay in-array (invalid slots are masked out later)
    h0, w0 = pyr_l.shape[1], pyr_l.shape[2]
    dy = jnp.arange(-SAD_W, SAD_W + 1)
    dxl = jnp.arange(-SAD_W, SAD_W + 1)
    dxr = jnp.arange(-SAD_W - SAD_L, SAD_W + SAD_L + 1)      # [21]

    gy = jnp.clip(sv_l[:, None] + dy[None, :], 0, h0 - 1)            # [N, 11]
    gxl = jnp.clip(su_l[:, None] + dxl[None, :], 0, w0 - 1)          # [N, 11]
    gxr = jnp.clip(su_r0[:, None] + dxr[None, :], 0, w0 - 1)         # [N, 21]

    patch_l, strip_r = sad_windows(pyr_l, pyr_r, oct_l, gy, gxl, gxr)

    patch_l = patch_l - patch_l[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    # windows for each shift inc in [-L, L]: strip[:, :, inc+L : inc+L+11]
    sad = []
    for inc in range(2 * SAD_L + 1):
        win = strip_r[:, :, inc:inc + 2 * SAD_W + 1]
        win = win - win[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
        sad.append(jnp.sum(jnp.abs(patch_l - win), axis=(1, 2)))
    sad = jnp.stack(sad, axis=1)                                     # [N, 11]

    best_inc = jnp.argmin(sad, axis=1)                               # 0..10
    best_sad = jnp.take_along_axis(sad, best_inc[:, None], axis=1)[:, 0]
    interior = (best_inc > 0) & (best_inc < 2 * SAD_L)
    im1 = jnp.take_along_axis(sad, jnp.maximum(best_inc - 1, 0)[:, None], axis=1)[:, 0]
    ip1 = jnp.take_along_axis(sad, jnp.minimum(best_inc + 1, 2 * SAD_L)[:, None], axis=1)[:, 0]
    denom = 2.0 * (im1 + ip1 - 2.0 * best_sad)
    delta = jnp.where(jnp.abs(denom) > 1e-6, (im1 - ip1) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1.0), 2.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    scale_l = scale_factors[oct_l]
    best_u_r = scale_l * (su_r0.astype(jnp.float32) + (best_inc - SAD_L).astype(jnp.float32) + delta)
    disparity = uL - best_u_r
    disp_in_range = (disparity >= 0.0) & (disparity < max_d)
    # clamp tiny/negative disparities like the reference
    tiny = disparity <= 0.0
    disparity = jnp.where(tiny, 0.01, disparity)
    best_u_r = jnp.where(tiny, uL - 0.01, best_u_r)

    accept = cand_ok & in_bounds & interior & delta_ok & disp_in_range & valid_l

    # ---- median SAD outlier cut -------------------------------------
    n_acc = jnp.sum(accept)
    sad_sorted = jnp.sort(jnp.where(accept, best_sad, jnp.inf))
    median = sad_sorted[jnp.clip(n_acc // 2, 0, best_sad.shape[0] - 1)]
    th_dist = 1.5 * 1.4 * median
    accept = accept & (best_sad < th_dist)

    depth = jnp.where(accept, bf / disparity, -1.0)
    u_right = jnp.where(accept, best_u_r, -1.0)
    best_right = jnp.where(accept, best_r, -1)
    return StereoMatches(u_right=u_right, depth=depth, best_right=best_right)
