"""Projection-guided descriptor matching (device kernels).

Rebuilds the reference's ORBmatcher::SearchByProjection family
(src/ORBmatcher.cc) as dense masked Hamming problems:

- ``match_last_frame``: motion-model tracking variant
  (ORBmatcher.cc:1328-1470) — project the previous frame's map points into
  the current frame, gate by window radius th*scale[last octave], forward/
  backward octave rules, right-u consistency, Hamming < TH_HIGH, and a
  30-bin rotation-consistency histogram.
- ``match_local_points``: track-local-map variant (ORBmatcher.cc:45-157) —
  frustum gating, distance-predicted scale level, view-cos radius, best/
  second-best ratio within same level.

Each returns per-point best-feature assignments; the tiny uniqueness
resolution (several points claiming one feature) is done with a segment-min
on device.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.ops.hamming import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30
BIG = 1 << 10


class ProjMatches(NamedTuple):
    feat_idx: jnp.ndarray   # [P] int32 best feature per point (-1 none)
    dist: jnp.ndarray       # [P] int32 Hamming distance
    n_matches: jnp.ndarray  # int32 (after uniqueness resolution)
    point_of_feat: jnp.ndarray  # [N] int32 winning point per feature (-1)


def _resolve_unique(best_feat, best_dist, has, n_feats):
    """Each feature keeps only the lowest-distance claiming point."""
    P = best_feat.shape[0]
    feat_safe = jnp.where(has, best_feat, n_feats)  # park invalid in slot n_feats
    # segment-min of dist over features
    INF = jnp.asarray(BIG, jnp.int32)
    seg_min = jnp.full((n_feats + 1,), INF).at[feat_safe].min(best_dist)
    win_dist = seg_min[feat_safe]
    is_winner = has & (best_dist == win_dist)
    # among ties, keep lowest point index
    pid = jnp.arange(P, dtype=jnp.int32)
    seg_pid = jnp.full((n_feats + 1,), jnp.asarray(P, jnp.int32)).at[
        jnp.where(is_winner, feat_safe, n_feats)].min(pid)
    final = is_winner & (seg_pid[feat_safe] == pid)
    feat_idx = jnp.where(final, best_feat, -1)
    point_of_feat = jnp.full((n_feats + 1,), -1, jnp.int32).at[
        jnp.where(final, feat_safe, n_feats)].max(pid)[:n_feats]
    return feat_idx, point_of_feat, jnp.sum(final).astype(jnp.int32)


def _rotation_consistency(ang_ref, ang_cur, has):
    """Keep only matches in the 3 dominant rotation-histogram bins
    (ORBmatcher::ComputeThreeMaxima semantics, 1601-1645)."""
    rot = ang_ref - ang_cur
    rot = jnp.where(rot < 0, rot + 360.0, rot)
    binf = jnp.round(rot * (HISTO_BINS / 360.0))
    bins = jnp.where(binf == HISTO_BINS, 0, binf).astype(jnp.int32)
    bins = jnp.clip(bins, 0, HISTO_BINS - 1)
    counts = jnp.zeros((HISTO_BINS,), jnp.int32).at[
        jnp.where(has, bins, 0)].add(has.astype(jnp.int32))
    top3_vals, top3_idx = jax.lax.top_k(counts, 3)
    max1 = top3_vals[0]
    # reference drops bins with count < 0.1 * max
    keep_bin = jnp.zeros((HISTO_BINS,), bool)
    for k in range(3):
        ok = top3_vals[k].astype(jnp.float32) >= 0.1 * max1.astype(jnp.float32)
        keep_bin = keep_bin.at[top3_idx[k]].set(ok)
    return has & keep_bin[bins]


def match_last_frame(xw, desc_p, oct_p, ang_p, valid_p,
                     R, t, feat_xy, feat_ur, feat_oct, feat_ang, feat_desc,
                     feat_valid, feat_taken,
                     fx, fy, cx, cy, bf, width, height,
                     scale_factors, th, forward, backward) -> ProjMatches:
    """Motion-model search.  xw [P,3] world points from the last frame with
    their descriptors/octaves/angles; feat_* are current-frame features.
    forward/backward: scalar bools (tz > b / tz < -b)."""
    P = xw.shape[0]
    N = feat_xy.shape[0]
    xc = jnp.einsum("ij,pj->pi", R, xw) + t
    z = xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = fx * xc[:, 0] * iz + cx
    v = fy * xc[:, 1] * iz + cy
    ur = u - bf * iz
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)

    radius = th * scale_factors[oct_p]                       # [P]
    du = jnp.abs(feat_xy[None, :, 0] - u[:, None])
    dv = jnp.abs(feat_xy[None, :, 1] - v[:, None])
    win_ok = (du < radius[:, None]) & (dv < radius[:, None])

    lo = oct_p[:, None]
    lf = feat_oct[None, :]
    oct_ok = jnp.where(forward, lf >= lo,
                       jnp.where(backward, lf <= lo,
                                 (lf >= lo - 1) & (lf <= lo + 1)))

    r_ok = jnp.where(feat_ur[None, :] > 0,
                     jnp.abs(ur[:, None] - feat_ur[None, :]) < radius[:, None],
                     True)

    ok = (win_ok & oct_ok & r_ok & valid_p[:, None] & in_img[:, None] &
          feat_valid[None, :] & ~feat_taken[None, :])
    D = jnp.where(ok, hamming_matrix(desc_p, feat_desc), BIG)
    best_feat = jnp.argmin(D, axis=1).astype(jnp.int32)
    best_dist = jnp.take_along_axis(D, best_feat[:, None], axis=1)[:, 0]
    has = best_dist <= TH_HIGH

    # rotation histogram filter
    ang_cur = feat_ang[best_feat]
    has = _rotation_consistency(ang_p, ang_cur, has)

    feat_idx, point_of_feat, n = _resolve_unique(best_feat, best_dist, has, N)
    return ProjMatches(feat_idx=feat_idx, dist=best_dist, n_matches=n,
                       point_of_feat=point_of_feat)


def match_local_points(xw, desc_p, valid_p,
                       normal_p, max_dist_p, min_dist_p,
                       R, t, ow,
                       feat_xy, feat_ur, feat_oct, feat_desc, feat_valid,
                       feat_taken,
                       fx, fy, cx, cy, bf, width, height,
                       scale_factors, log_scale, n_levels, th,
                       nn_ratio=0.8) -> ProjMatches:
    """Track-local-map search (SearchByProjection with MapPoints).

    normal_p: mean viewing direction; min/max_dist: scale-invariance range;
    ow: camera centre in world."""
    P = xw.shape[0]
    N = feat_xy.shape[0]
    xc = jnp.einsum("ij,pj->pi", R, xw) + t
    z = xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = fx * xc[:, 0] * iz + cx
    v = fy * xc[:, 1] * iz + cy
    ur = u - bf * iz
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)

    po = xw - ow[None, :]
    dist = jnp.linalg.norm(po, axis=-1)
    dist_ok = (dist >= min_dist_p) & (dist <= max_dist_p)
    view_cos = jnp.sum(po * normal_p, axis=-1) / jnp.where(dist < 1e-9, 1e-9, dist)
    view_ok = view_cos > 0.5

    # predicted scale level (MapPoint::PredictScale)
    ratio = max_dist_p / jnp.where(dist < 1e-9, 1e-9, dist)
    pred = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / log_scale).astype(jnp.int32)
    pred = jnp.clip(pred, 0, n_levels - 1)

    r_base = jnp.where(view_cos > 0.998, 2.5, 4.0)
    radius = th * r_base * scale_factors[pred]

    du = jnp.abs(feat_xy[None, :, 0] - u[:, None])
    dv = jnp.abs(feat_xy[None, :, 1] - v[:, None])
    win_ok = (du < radius[:, None]) & (dv < radius[:, None])
    lf = feat_oct[None, :]
    oct_ok = (lf >= pred[:, None] - 1) & (lf <= pred[:, None])
    r_ok = jnp.where(feat_ur[None, :] > 0,
                     jnp.abs(ur[:, None] - feat_ur[None, :]) < radius[:, None],
                     True)
    frustum = in_img & dist_ok & view_ok & valid_p
    ok = (win_ok & oct_ok & r_ok & frustum[:, None] &
          feat_valid[None, :] & ~feat_taken[None, :])

    D = jnp.where(ok, hamming_matrix(desc_p, feat_desc), BIG)
    # best and second-best (second at a different level requirement)
    best_feat = jnp.argmin(D, axis=1).astype(jnp.int32)
    best_dist = jnp.take_along_axis(D, best_feat[:, None], axis=1)[:, 0]
    best_lvl = feat_oct[best_feat]
    D2 = D.at[jnp.arange(P), best_feat].set(BIG)
    second_feat = jnp.argmin(D2, axis=1).astype(jnp.int32)
    second_dist = jnp.take_along_axis(D2, second_feat[:, None], axis=1)[:, 0]
    second_lvl = feat_oct[second_feat]

    ratio_rej = (best_lvl == second_lvl) & \
        (best_dist.astype(jnp.float32) > nn_ratio * second_dist.astype(jnp.float32)) & \
        (second_dist < BIG)
    has = (best_dist <= TH_HIGH) & ~ratio_rej

    feat_idx, point_of_feat, n = _resolve_unique(best_feat, best_dist, has, N)
    return ProjMatches(feat_idx=feat_idx, dist=best_dist, n_matches=n,
                       point_of_feat=point_of_feat)
