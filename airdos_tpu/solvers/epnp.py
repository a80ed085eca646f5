"""EPnP (Lepetit et al.) with vmapped RANSAC, for relocalization.

Rebuild of PnPsolver (reference: src/PnPsolver.cc): 4 control points via
PCA, barycentric coordinates, the 2n x 12 M-matrix null space, beta cases
with Gauss-Newton refinement on the 6 control-point distances, and Horn
R, t recovery; RANSAC with per-scale chi2 inlier thresholds
(mvMaxError[octave] = 5.991 * sigma2, parameters from Tracking.cc:1538).

Batched form: hypotheses are one leading batch axis — hundreds of EPnP solves
(eigen-decompositions, GN iterations, Horn alignments) execute as one
vmapped program; inlier counting is a dense masked reduction.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.solvers.align import horn_align


def _control_points(pw: jnp.ndarray, w: jnp.ndarray):
    """pw [n,3], w [n] -> control points [4,3] (centroid + PCA axes)."""
    wn = w / jnp.maximum(jnp.sum(w), 1e-12)
    c0 = jnp.sum(pw * wn[:, None], axis=0)
    Q = (pw - c0) * jnp.sqrt(wn)[:, None]
    C = Q.T @ Q
    evals, evecs = jnp.linalg.eigh(C)
    # eigh ascending; use all three axes
    lam = jnp.sqrt(jnp.maximum(evals, 1e-12))
    cps = [c0]
    for i in range(3):
        cps.append(c0 + lam[2 - i] * evecs[:, 2 - i])
    return jnp.stack(cps)                      # [4, 3]


def _barycentric(pw: jnp.ndarray, cps: jnp.ndarray):
    """alphas [n, 4] with sum = 1 such that pw = alphas @ cps."""
    A = jnp.concatenate([cps.T, jnp.ones((1, 4), pw.dtype)], axis=0)   # [4,4]
    B = jnp.concatenate([pw.T, jnp.ones((1, pw.shape[0]), pw.dtype)], axis=0)
    al = jnp.linalg.solve(A + 1e-9 * jnp.eye(4, dtype=pw.dtype), B)
    return al.T


def _build_M(alphas, uv, w, fx, fy, cx, cy):
    """M [2n, 12]; rows weighted by sqrt(w)."""
    n = alphas.shape[0]
    sw = jnp.sqrt(w)[:, None]
    a = alphas                                    # [n, 4]
    u = uv[:, 0:1]
    v = uv[:, 1:2]
    zeros = jnp.zeros_like(a)
    # row for u: [a*fx, 0, a*(cx-u)] per control point
    Mu = jnp.concatenate([
        (a * fx)[:, :, None],
        zeros[:, :, None],
        (a * (cx - u))[:, :, None]], axis=2).reshape(n, 12) * sw
    Mv = jnp.concatenate([
        zeros[:, :, None],
        (a * fy)[:, :, None],
        (a * (cy - v))[:, :, None]], axis=2).reshape(n, 12) * sw
    return jnp.concatenate([Mu, Mv], axis=0)


def _rho_L(V):
    """Pairwise control-point distance system.  V: [12, 4] nullspace basis
    (columns = 4 smallest singular vectors, each 4 control points x 3)."""
    v = V.T.reshape(4, 4, 3)                      # [basis, cp, 3]
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    dv = jnp.stack([v[:, i] - v[:, j] for i, j in pairs], axis=1)  # [4, 6, 3]
    # distances in camera frame: x = sum_k beta_k v_k =>
    # |dx|^2 = sum_kl beta_k beta_l (dv_k . dv_l): quadratic form per pair
    G = jnp.einsum("kpi,lpi->pkl", dv, dv)        # [6, 4, 4]
    return G


def _betas_gn(G, rho, betas0, iters: int = 6):
    """Gauss-Newton on f_p(beta) = beta^T G_p beta - rho_p."""
    def body(_, b):
        f = jnp.einsum("k,pkl,l->p", b, G, b) - rho
        J = 2.0 * jnp.einsum("pkl,l->pk", G, b)
        H = J.T @ J + 1e-9 * jnp.eye(4, dtype=b.dtype)
        g = J.T @ f
        return b - jnp.linalg.solve(H, g)
    return jax.lax.fori_loop(0, iters, body, betas0)


def epnp_pose(pw: jnp.ndarray, uv: jnp.ndarray, w: jnp.ndarray,
              fx, fy, cx, cy):
    """Weighted EPnP.  pw [n, 3] world, uv [n, 2] pixels, w [n] weights.
    Returns (R, t) with x_cam = R x_world + t."""
    cps = _control_points(pw, w)
    alphas = _barycentric(pw, cps)
    M = _build_M(alphas, uv, w, fx, fy, cx, cy)
    MtM = M.T @ M
    evals, evecs = jnp.linalg.eigh(MtM)
    V = evecs[:, :4]                               # 4 smallest
    G = _rho_L(V)
    pairs_idx = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    rho = jnp.stack([jnp.sum((cps[i] - cps[j]) ** 2) for i, j in pairs_idx])

    # beta init case N=1 on each basis vector, pick best after GN
    def solve_from(b0):
        b = _betas_gn(G, rho, b0)
        x = (V @ b).reshape(4, 3)                  # camera-frame control pts
        pc = alphas @ x                            # camera-frame points
        # enforce positive depth (sign ambiguity)
        sign = jnp.where(jnp.sum(w * pc[:, 2]) < 0, -1.0, 1.0)
        pc = pc * sign
        R, t, _ = horn_align(pc, pw, weights=w, fix_scale=True)
        return R, t, pc

    def reproj_err(R, t):
        xc = pw @ R.T + t
        z = jnp.where(jnp.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
        u = fx * xc[:, 0] / z + cx
        v = fy * xc[:, 1] / z + cy
        return jnp.sum(w * ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2))

    best = None
    candidates = []
    for k in range(2):
        # case-1 style init on basis k (scaled to match rho on average)
        gkk = jnp.stack([G[p, k, k] for p in range(6)])
        scale = jnp.sqrt(jnp.sum(rho * gkk) / jnp.maximum(jnp.sum(gkk * gkk), 1e-12))
        b0 = jnp.zeros(4, pw.dtype).at[k].set(scale)
        R, t, _ = solve_from(b0)
        candidates.append((reproj_err(R, t), R, t))
    err0, R0, t0 = candidates[0]
    err1, R1, t1 = candidates[1]
    take0 = err0 <= err1
    R = jnp.where(take0, R0, R1)
    t = jnp.where(take0, t0, t1)
    return R, t


class PnPRansacResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray     # [n] bool
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("min_inliers",))
def epnp_ransac(pw, uv, valid, max_err2,
                sample_idx,                 # [H, 4] precomputed samples
                fx, fy, cx, cy, min_inliers: int = 10) -> PnPRansacResult:
    """Vmapped EPnP RANSAC (reference PnPsolver::iterate semantics:
    minSet=4, chi2 gate per-scale via max_err2 [n])."""
    n = pw.shape[0]

    def one_hyp(idx):
        pws = pw[idx]
        uvs = uv[idx]
        w = jnp.ones(4, pw.dtype)
        R, t = epnp_pose(pws, uvs, w, fx, fy, cx, cy)
        xc = pw @ R.T + t
        z = jnp.where(jnp.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
        u = fx * xc[:, 0] / z + cx
        v = fy * xc[:, 1] / z + cy
        err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        inl = valid & (err2 < max_err2) & (z > 0)
        return R, t, inl, jnp.sum(inl)

    Rs, ts, inls, counts = jax.vmap(one_hyp)(sample_idx)
    best = jnp.argmax(counts)
    R_b, t_b, inl_b = Rs[best], ts[best], inls[best]

    # refine on the best inlier set (weighted EPnP over all points)
    w_ref = inl_b.astype(pw.dtype)
    R_r, t_r = epnp_pose(pw, uv, w_ref + 1e-6, fx, fy, cx, cy)
    xc = pw @ R_r.T + t_r
    z = jnp.where(jnp.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
    u = fx * xc[:, 0] / z + cx
    v = fy * xc[:, 1] / z + cy
    err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    inl_r = valid & (err2 < max_err2) & (z > 0)
    better = jnp.sum(inl_r) >= jnp.sum(inl_b)
    R_f = jnp.where(better, R_r, R_b)
    t_f = jnp.where(better, t_r, t_b)
    inl_f = jnp.where(better, inl_r, inl_b)
    return PnPRansacResult(R=R_f, t=t_f, inliers=inl_f,
                           n_inliers=jnp.sum(inl_f))
