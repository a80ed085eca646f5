"""Sim3/SE3 solvers for loop closing.

- sim3_ransac: Horn closed-form on 3-point samples with mutual-reprojection
  chi2 inlier checks — rebuild of Sim3Solver (reference: src/Sim3Solver.cc,
  RANSAC over 3-point sets, scale fixed for stereo).
- optimize_sim3: GN refinement of a KF-pair Sim3 with mutual projection
  edges and inlier re-check — rebuild of Optimizer::OptimizeSim3
  (src/Optimizer.cc:2474-2660).

Hypotheses batch over the leading axis (vmapped Horn + eigh).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.geometry.se3 import so3_exp
from airdos_tpu.solvers.align import horn_align


class Sim3RansacResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    s: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("fix_scale",))
def sim3_ransac(x1, x2, valid,            # [n, 3] camera-frame points, both KFs
                sample_idx,               # [H, 3]
                max_err1, max_err2,       # [n] chi2 gates (9.210 * sigma2)
                fx, fy, cx, cy,
                fix_scale: bool = True) -> Sim3RansacResult:
    """Find S12 (x1 ~ S12 x2) by RANSAC over 3-point Horn alignments with
    mutual reprojection checks (project x2 into cam1 via S12 and x1 into
    cam2 via S21)."""

    def reproj_inliers(R, t, s):
        p1 = s * (x2 @ R.T) + t                  # x2 mapped into frame 1
        z1 = jnp.where(jnp.abs(p1[:, 2]) < 1e-9, 1e-9, p1[:, 2])
        u1 = fx * p1[:, 0] / z1 + cx
        v1 = fy * p1[:, 1] / z1 + cy
        z1o = jnp.where(jnp.abs(x1[:, 2]) < 1e-9, 1e-9, x1[:, 2])
        e1 = (u1 - (fx * x1[:, 0] / z1o + cx)) ** 2 + \
             (v1 - (fy * x1[:, 1] / z1o + cy)) ** 2
        s_inv = 1.0 / s
        p2 = s_inv * ((x1 - t) @ R)              # R^T (x1 - t) / s
        z2 = jnp.where(jnp.abs(p2[:, 2]) < 1e-9, 1e-9, p2[:, 2])
        u2 = fx * p2[:, 0] / z2 + cx
        v2 = fy * p2[:, 1] / z2 + cy
        z2o = jnp.where(jnp.abs(x2[:, 2]) < 1e-9, 1e-9, x2[:, 2])
        e2 = (u2 - (fx * x2[:, 0] / z2o + cx)) ** 2 + \
             (v2 - (fy * x2[:, 1] / z2o + cy)) ** 2
        return valid & (e1 < max_err1) & (e2 < max_err2)

    def one_hyp(idx):
        R, t, s = horn_align(x1[idx], x2[idx], fix_scale=fix_scale)
        inl = reproj_inliers(R, t, s)
        return R, t, s, inl, jnp.sum(inl)

    Rs, ts, ss, inls, counts = jax.vmap(one_hyp)(sample_idx)
    best = jnp.argmax(counts)
    R_b, t_b, s_b, inl_b = Rs[best], ts[best], ss[best], inls[best]
    # refine on inliers
    w = inl_b.astype(x1.dtype)
    R_r, t_r, s_r = horn_align(x1, x2, weights=w + 1e-6, fix_scale=fix_scale)
    inl_r = reproj_inliers(R_r, t_r, s_r)
    better = jnp.sum(inl_r) >= jnp.sum(inl_b)
    R_f = jnp.where(better, R_r, R_b)
    t_f = jnp.where(better, t_r, t_b)
    s_f = jnp.where(better, s_r, s_b)
    inl_f = jnp.where(better, inl_r, inl_b)
    return Sim3RansacResult(R=R_f, t=t_f, s=s_f, inliers=inl_f,
                            n_inliers=jnp.sum(inl_f))


@partial(jax.jit, static_argnames=("fix_scale", "n_iters"))
def optimize_sim3(R0, t0, s0,
                  x1, obs1, sig1,         # points in cam1 + their obs in cam1
                  x2, obs2, sig2,         # points in cam2 + their obs in cam2
                  valid,
                  fx, fy, cx, cy,
                  th2: float = 10.0, fix_scale: bool = True,
                  n_iters: int = 10):
    """GN on the 7-DoF (or 6 with fixed scale) S12 with mutual projection
    residuals: project S12 x2 against obs1 and S12^-1 x1 against obs2."""
    dtype = x1.dtype

    def residuals(params):
        w, u, sigma = params[:3], params[3:6], params[6]
        dR = so3_exp(w)
        s = s0 * jnp.exp(sigma)
        R = dR @ R0
        t = t0 + u
        p1 = s * (x2 @ R.T) + t
        z1 = jnp.where(jnp.abs(p1[:, 2]) < 1e-9, 1e-9, p1[:, 2])
        r1 = obs1 - jnp.stack([fx * p1[:, 0] / z1 + cx,
                               fy * p1[:, 1] / z1 + cy], axis=1)
        p2 = ((x1 - t) @ R) / s
        z2 = jnp.where(jnp.abs(p2[:, 2]) < 1e-9, 1e-9, p2[:, 2])
        r2 = obs2 - jnp.stack([fx * p2[:, 0] / z2 + cx,
                               fy * p2[:, 1] / z2 + cy], axis=1)
        return r1, r2

    def chi2(params, act):
        r1, r2 = residuals(params)
        c1 = jnp.sum(r1 * r1, axis=1) / sig1
        c2 = jnp.sum(r2 * r2, axis=1) / sig2
        return c1, c2

    def cost(params, act):
        c1, c2 = chi2(params, act)
        return jnp.sum((jnp.minimum(c1, 2 * th2) + jnp.minimum(c2, 2 * th2)) * act)

    def gn(params, act, iters):
        def body(_, carry):
            p, lam, f_prev = carry
            r1, r2 = residuals(p)
            J1 = jax.jacfwd(lambda q: residuals(q)[0])(p).reshape(-1, 7)
            J2 = jax.jacfwd(lambda q: residuals(q)[1])(p).reshape(-1, 7)
            w1 = jnp.repeat(act / sig1, 2)
            w2 = jnp.repeat(act / sig2, 2)
            H = (J1 * w1[:, None]).T @ J1 + (J2 * w2[:, None]).T @ J2
            g = -(J1 * w1[:, None]).T @ r1.reshape(-1) - \
                (J2 * w2[:, None]).T @ r2.reshape(-1)
            if fix_scale:
                H = H.at[6, :].set(0).at[:, 6].set(0).at[6, 6].set(1.0)
                g = g.at[6].set(0.0)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(7, dtype=dtype)
            dp = jnp.linalg.solve(Hd, g)
            pn = p + dp
            f_new = cost(pn, act)
            better = f_new < f_prev
            return (jnp.where(better, pn, p),
                    jnp.where(better, lam * 0.3, lam * 8.0),
                    jnp.where(better, f_new, f_prev))
        p, _, _ = jax.lax.fori_loop(
            0, iters, body, (params, jnp.asarray(1e-4, dtype),
                             cost(params, act)))
        return p

    p0 = jnp.zeros(7, dtype)
    act = valid.astype(dtype)
    p = gn(p0, act, n_iters // 2)
    c1, c2 = chi2(p, act)
    inl = valid & (c1 < th2) & (c2 < th2)
    p = gn(p, inl.astype(dtype), n_iters)
    c1, c2 = chi2(p, inl.astype(dtype))
    inl = valid & (c1 < th2) & (c2 < th2)
    w, u, sigma = p[:3], p[3:6], p[6]
    R = so3_exp(w) @ R0
    t = t0 + u
    s = s0 * jnp.exp(sigma)
    return R, t, s, inl, jnp.sum(inl)
