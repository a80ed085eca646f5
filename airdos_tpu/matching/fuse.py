"""Reprojection-based duplicate-point fusion.

Rebuild of ORBmatcher::Fuse (reference: src/ORBmatcher.cc:825-975): project
map points into a target keyframe, search a 3*scale[predicted level] window
at levels [pred-1, pred], require Hamming <= TH_LOW and reprojection
chi-square (5.99 mono / 7.8 stereo); the host then either merges the hit
feature's existing point or adds a new observation.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.ops.hamming import hamming_matrix

TH_LOW = 50
BIG = 1 << 10


class FuseMatches(NamedTuple):
    feat_idx: jnp.ndarray    # [P] best feature in target KF (-1 none)
    dist: jnp.ndarray        # [P]


def fuse_candidates(xw, desc_p, valid_p, normal_p, max_dist_p, min_dist_p,
                    R, t, ow,
                    feat_xy, feat_ur, feat_oct, feat_desc, feat_valid,
                    fx, fy, cx, cy, bf, width, height,
                    scale_factors, sigma2, log_scale, n_levels,
                    th: float = 3.0) -> FuseMatches:
    P = xw.shape[0]
    xc = jnp.einsum("ij,pj->pi", R, xw) + t
    z = xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = fx * xc[:, 0] * iz + cx
    v = fy * xc[:, 1] * iz + cy
    ur = u - bf * iz
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)

    po = xw - ow[None, :]
    dist3d = jnp.linalg.norm(po, axis=-1)
    dist_ok = (dist3d >= min_dist_p) & (dist3d <= max_dist_p)
    view_cos = jnp.sum(po * normal_p, axis=-1) / jnp.maximum(dist3d, 1e-9)
    view_ok = view_cos > 0.5

    ratio = max_dist_p / jnp.maximum(dist3d, 1e-9)
    pred = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / log_scale).astype(jnp.int32)
    pred = jnp.clip(pred, 0, n_levels - 1)
    radius = th * scale_factors[pred]

    du = feat_xy[None, :, 0] - u[:, None]
    dv = feat_xy[None, :, 1] - v[:, None]
    win_ok = (jnp.abs(du) < radius[:, None]) & (jnp.abs(dv) < radius[:, None])
    lf = feat_oct[None, :]
    oct_ok = (lf >= pred[:, None] - 1) & (lf <= pred[:, None] + 1)

    # reprojection chi2 per candidate pair
    s2 = sigma2[feat_oct][None, :]
    e2 = du * du + dv * dv
    der = feat_ur[None, :] - ur[:, None]
    has_r = (feat_ur >= 0)[None, :]
    chi = jnp.where(has_r, (e2 + der * der) / s2, e2 / s2)
    chi_ok = jnp.where(has_r, chi <= 7.8, chi <= 5.99)

    frustum = in_img & dist_ok & view_ok & valid_p
    ok = win_ok & oct_ok & chi_ok & frustum[:, None] & feat_valid[None, :]
    D = jnp.where(ok, hamming_matrix(desc_p, feat_desc), BIG)
    best = jnp.argmin(D, axis=1).astype(jnp.int32)
    bdist = jnp.take_along_axis(D, best[:, None], axis=1)[:, 0]
    feat_idx = jnp.where(bdist <= TH_LOW, best, -1)
    return FuseMatches(feat_idx=feat_idx, dist=bdist)
