"""Sim3-guided mutual matching (SearchBySim3).

Rebuild of ORBmatcher::SearchBySim3 (reference: src/ORBmatcher.cc:1102-1326):
after a RANSAC Sim3 between two keyframes, grow the match set by projecting
each KF's map points into the other camera through S12 / S21, gating by the
scale-predicted window (th = 7.5 * scale[level]), taking the best Hamming
match under TH_HIGH in each direction, and keeping only mutually-agreeing
pairs that are not already matched.

Dense form: the per-feature point tables of both keyframes are projected in
one shot; the two direction searches are two masked dense Hamming problems;
mutual agreement is a gather-compare.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from airdos_tpu.ops.hamming import hamming_matrix

TH_HIGH = 100
BIG = 1 << 10


class Sim3Matches(NamedTuple):
    idx2_of_1: jnp.ndarray   # [N1] mutual match in KF2 (-1 none)
    n_matches: jnp.ndarray


def _directional(x_in_cam, valid_p, desc_p, maxd_p,
                 feat_xy, feat_oct, feat_desc, feat_valid,
                 fx, fy, cx, cy, width, height,
                 scale_factors, log_scale, n_levels, th):
    """Best target feature per source point (points already in the target
    camera frame).  Returns best feature index [P] and validity mask."""
    z = x_in_cam[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * x_in_cam[:, 0] * iz + cx
    v = fy * x_in_cam[:, 1] * iz + cy
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)

    dist = jnp.linalg.norm(x_in_cam, axis=-1)
    # PredictScale from the point's max scale-invariance distance
    ratio = maxd_p / jnp.where(dist < 1e-9, 1e-9, dist)
    pred = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / log_scale)
    pred = jnp.clip(pred, 0, n_levels - 1).astype(jnp.int32)
    dist_ok = (dist >= 0.8 * jnp.where(maxd_p > 0, maxd_p, 1e9) /
               scale_factors[n_levels - 1]) & (dist <= 1.2 * maxd_p)

    radius = th * scale_factors[pred]
    du = jnp.abs(feat_xy[None, :, 0] - u[:, None])
    dv = jnp.abs(feat_xy[None, :, 1] - v[:, None])
    win_ok = (du < radius[:, None]) & (dv < radius[:, None])
    lf = feat_oct[None, :]
    oct_ok = (lf >= pred[:, None] - 1) & (lf <= pred[:, None])
    ok = (win_ok & oct_ok & (valid_p & in_img & dist_ok)[:, None] &
          feat_valid[None, :])
    D = jnp.where(ok, hamming_matrix(desc_p, feat_desc), BIG)
    best = jnp.argmin(D, axis=1).astype(jnp.int32)
    bdist = jnp.take_along_axis(D, best[:, None], axis=1)[:, 0]
    has = bdist <= TH_HIGH
    return best, has


def match_by_sim3(x2_in_c1, valid2, desc2, maxd2,
                  x1_in_c2, valid1, desc1, maxd1,
                  feat1_xy, feat1_oct, feat1_desc, feat1_valid,
                  feat2_xy, feat2_oct, feat2_desc, feat2_valid,
                  fx, fy, cx, cy, width, height,
                  scale_factors, log_scale, n_levels,
                  th: float = 7.5) -> Sim3Matches:
    """x2_in_c1: KF2's per-feature map points transformed into camera 1 by
    S12 * T2w; x1_in_c2: KF1's points into camera 2.  desc*/maxd* are the
    POINT descriptors / max scale distances laid out per feature slot;
    valid* marks slots carrying a live, not-yet-matched point."""
    # direction A: KF2 points -> KF1 features; bestA [N2]
    bestA, hasA = _directional(x2_in_c1, valid2, desc2, maxd2,
                               feat1_xy, feat1_oct, feat1_desc, feat1_valid,
                               fx, fy, cx, cy, width, height,
                               scale_factors, log_scale, n_levels, th)
    # direction B: KF1 points -> KF2 features; bestB [N1]
    bestB, hasB = _directional(x1_in_c2, valid1, desc1, maxd1,
                               feat2_xy, feat2_oct, feat2_desc, feat2_valid,
                               fx, fy, cx, cy, width, height,
                               scale_factors, log_scale, n_levels, th)
    # mutual agreement: bestA[bestB[f1]] == f1
    N1 = x1_in_c2.shape[0]
    f1 = jnp.arange(N1, dtype=jnp.int32)
    back = bestA[bestB]                       # [N1]
    agree = hasB & hasA[bestB] & (back == f1)
    idx2 = jnp.where(agree, bestB, -1)
    return Sim3Matches(idx2_of_1=idx2,
                       n_matches=jnp.sum(agree).astype(jnp.int32))
