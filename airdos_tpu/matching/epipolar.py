"""Epipolar-constrained matching + two-view triangulation of new map points.

Rebuild of LocalMapping::CreateNewMapPoints (reference:
src/LocalMapping.cc:221-466) and ORBmatcher::SearchForTriangulation
(src/ORBmatcher.cc:657-823): for a keyframe pair, match features that have
no map point yet under the epipolar constraint (distance to epipolar line
< 3.84 sigma^2), Hamming < TH_LOW, then linearly triangulate and validate
(parallax, positive depth in both views, reprojection chi2, scale
consistency).  Stereo depth wins over triangulation at low parallax.

The reference walks shared BoW nodes to limit candidates; this version
evaluates the full dense N1 x N2 masked Hamming matrix in one shot.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.ops.hamming import hamming_matrix
from airdos_tpu.solvers.smallmat import inv3x3

TH_LOW = 50
BIG = 1 << 10


class TriangulationResult(NamedTuple):
    idx2: jnp.ndarray        # [N1] matched feature in KF2 (-1 none)
    points: jnp.ndarray      # [N1, 3] triangulated world points
    valid: jnp.ndarray       # [N1] bool — passed every check
    from_stereo1: jnp.ndarray  # [N1] bool — use KF1 stereo depth instead
    from_stereo2: jnp.ndarray  # [N1] bool


def triangulate_pair(
        # KF1 (the new keyframe)
        xy1, oct1, ur1, depth1, desc1, free1,
        R1, t1,
        # KF2 (neighbor)
        xy2, oct2, ur2, depth2, desc2, free2,
        R2, t2,
        fx, fy, cx, cy, bf,
        scale_factors, sigma2, log_scale, n_levels) -> TriangulationResult:
    """free*: feature has no associated map point.  Poses are Tcw."""
    N1 = xy1.shape[0]

    # ---- epipolar geometry (F12 from relative pose) -------------------
    R12 = R1 @ R2.T
    t12 = t1 - R12 @ t2
    tx = jnp.array([[0, -t12[2], t12[1]],
                    [t12[2], 0, -t12[0]],
                    [-t12[1], t12[0], 0]], dtype=xy1.dtype)
    Kinv = jnp.array([[1 / fx, 0, -cx / fx],
                      [0, 1 / fy, -cy / fy],
                      [0, 0, 1]], dtype=xy1.dtype)
    F12 = Kinv.T @ tx @ R12 @ Kinv

    ones1 = jnp.ones((N1, 1), xy1.dtype)
    p1h = jnp.concatenate([xy1, ones1], axis=1)                  # [N1, 3]
    lines = p1h @ F12                                            # [N1, 3] line in image 2
    # distance from each x2 to each epipolar line
    dist_num = (lines[:, 0][:, None] * xy2[None, :, 0] +
                lines[:, 1][:, None] * xy2[None, :, 1] + lines[:, 2][:, None])
    dist2 = dist_num * dist_num / jnp.maximum(
        lines[:, 0][:, None] ** 2 + lines[:, 1][:, None] ** 2, 1e-12)
    epi_ok = dist2 < 3.84 * sigma2[oct2][None, :]

    # epipole in image 2: project camera-1 centre
    C1 = -R1.T @ t1
    e2c = R2 @ C1 + t2
    e2z = jnp.where(jnp.abs(e2c[2]) < 1e-9, 1e-9, e2c[2])
    ex, ey = fx * e2c[0] / e2z + cx, fy * e2c[1] / e2z + cy
    # reject matches too close to the epipole (mono only in reference)
    de2 = (xy2[:, 0] - ex) ** 2 + (xy2[:, 1] - ey) ** 2
    epi_far = de2[None, :] > 100.0 * scale_factors[oct2][None, :]
    is_stereo2 = ur2 >= 0
    epipole_ok = jnp.where(is_stereo2[None, :], True, epi_far)

    ok = epi_ok & epipole_ok & free1[:, None] & free2[None, :]
    D = jnp.where(ok, hamming_matrix(desc1, desc2), BIG)
    idx2 = jnp.argmin(D, axis=1).astype(jnp.int32)
    dist = jnp.take_along_axis(D, idx2[:, None], axis=1)[:, 0]
    has = dist < TH_LOW

    # ---- triangulate ---------------------------------------------------
    x2 = xy2[idx2]
    xn1 = jnp.stack([(xy1[:, 0] - cx) / fx, (xy1[:, 1] - cy) / fy,
                     jnp.ones(N1, xy1.dtype)], axis=1)
    xn2 = jnp.stack([(x2[:, 0] - cx) / fx, (x2[:, 1] - cy) / fy,
                     jnp.ones(N1, xy1.dtype)], axis=1)
    # parallax between rays (world frame)
    r1 = xn1 @ R1                                   # R1^T xn1
    r2 = xn2 @ R2
    cos_par = jnp.sum(r1 * r2, axis=1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=1) * jnp.linalg.norm(r2, axis=1), 1e-12)

    # stereo parallax (reference: 2 atan2(b/2, z))
    cos_s1 = jnp.where(depth1 > 0,
                       jnp.cos(2.0 * jnp.arctan2(bf / fx / 2.0, depth1)), 2.0)
    cos_s2 = jnp.where(depth2[idx2] > 0,
                       jnp.cos(2.0 * jnp.arctan2(bf / fx / 2.0, depth2[idx2])), 2.0)
    cos_stereo = jnp.minimum(cos_s1, cos_s2)

    # linear triangulation (DLT rows)
    P1 = jnp.concatenate([R1, t1[:, None]], axis=1)           # [3, 4]
    P2 = jnp.concatenate([R2, t2[:, None]], axis=1)

    def dlt(xn_a, xn_b):
        A0 = xn_a[:, 0:1] * P1[2][None] - P1[0][None]
        A1 = xn_a[:, 1:2] * P1[2][None] - P1[1][None]
        A2 = xn_b[:, 0:1] * P2[2][None] - P2[0][None]
        A3 = xn_b[:, 1:2] * P2[2][None] - P2[1][None]
        A = jnp.stack([A0, A1, A2, A3], axis=1)               # [N, 4, 4]
        # Inhomogeneous least squares with w=1: solve the 3x3 normal
        # equations (B^T B) X = -B^T c for A = [B | c].  Triangulated
        # points are finite (w != 0) by construction, and the degenerate
        # near-zero-parallax systems this is less robust to than the
        # homogeneous-SVD form are gated out by cos_par / chi2 below.
        # The closed form replaces a batched 4x4 SVD, which XLA lowers to
        # an iterative Jacobi loop (the two are not compared on the GPU).
        B = A[:, :, :3]
        c = A[:, :, 3]
        M = jnp.einsum("nri,nrj->nij", B, B)
        rhs = -jnp.einsum("nri,nr->ni", B, c)
        tr = jnp.trace(M, axis1=1, axis2=2)[:, None, None]
        Minv = inv3x3(M + (1e-7 * tr + 1e-12) *
                      jnp.eye(3, dtype=A.dtype)[None])
        return jnp.einsum("nij,nj->ni", Minv, rhs)

    Xtri = dlt(xn1, xn2)
    good_tri = (cos_par > 0) & (cos_par < 0.9998) & (cos_par < cos_stereo)
    use_s1 = (~good_tri) & (cos_s1 < cos_s2) & (depth1 > 0)
    use_s2 = (~good_tri) & (~use_s1) & (depth2[idx2] > 0)
    # stereo unprojections
    X1s = (xn1 * depth1[:, None]) @ R1 - (R1.T @ t1)[None, :]
    X2s = (xn2 * depth2[idx2][:, None]) @ R2 - (R2.T @ t2)[None, :]
    X = jnp.where(use_s1[:, None], X1s,
                  jnp.where(use_s2[:, None], X2s, Xtri))
    usable = good_tri | use_s1 | use_s2

    # ---- validity checks ----------------------------------------------
    def check_view(R, t, xy, octv, ur, X):
        xc = X @ R.T + t
        z = xc[:, 2]
        iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = fx * xc[:, 0] * iz + cx
        v = fy * xc[:, 1] * iz + cy
        urp = u - bf * iz
        s2 = sigma2[octv]
        eu, ev = u - xy[:, 0], v - xy[:, 1]
        err2 = eu * eu + ev * ev
        has_r = ur >= 0
        er = urp - ur
        chi = jnp.where(has_r, (err2 + er * er) / s2, err2 / s2)
        th = jnp.where(has_r, 7.8, 5.991)
        return (z > 0) & (chi < th), z

    ok1, z1 = check_view(R1, t1, xy1, oct1, ur1, X)
    ok2, z2 = check_view(R2, t2, x2, oct2[idx2], ur2[idx2], X)

    # scale consistency
    C1w = -R1.T @ t1
    C2w = -R2.T @ t2
    d1 = jnp.linalg.norm(X - C1w[None], axis=1)
    d2 = jnp.linalg.norm(X - C2w[None], axis=1)
    ratio_dist = d2 / jnp.maximum(d1, 1e-9)
    ratio_oct = scale_factors[oct1] / scale_factors[oct2[idx2]]
    ratio_factor = 1.5 * jnp.exp(log_scale)
    scale_ok = (ratio_dist * ratio_factor > ratio_oct) & \
               (ratio_dist < ratio_oct * ratio_factor) & \
               (d1 > 1e-6) & (d2 > 1e-6)

    valid = has & usable & ok1 & ok2 & scale_ok
    idx2 = jnp.where(valid, idx2, -1)
    return TriangulationResult(idx2=idx2, points=X, valid=valid,
                               from_stereo1=use_s1 & valid,
                               from_stereo2=use_s2 & valid)
