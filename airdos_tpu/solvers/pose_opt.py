"""Motion-only bundle adjustment (pose optimization).

Behavioral rebuild of Optimizer::PoseOptimization (reference:
src/Optimizer.cc:232-429): one SE3 camera vertex, unary stereo/mono
projection edges with fixed world points, 4 rounds x 10 LM iterations,
chi-square gating (5.991 mono / 7.815 stereo) re-classifying outliers
between rounds, Huber kernel dropped from round 3 on.

Static-shape redesign: edges live in fixed-size padded arrays; residuals/Jacobians
are analytic and vmapped; each round is a lax.fori_loop of damped
Gauss-Newton steps on a 6x6 system solved in-register.  The whole
4-round protocol is one jit.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.geometry.se3 import se3_exp, se3_compose, se3_inverse, \
    se3_log, so3_hat
from airdos_tpu.solvers.smallmat import inv6x6

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
N_ROUNDS = 4
N_ITERS = 10


class PoseOptResult(NamedTuple):
    R: jnp.ndarray          # [3, 3] optimized Tcw rotation
    t: jnp.ndarray          # [3]
    inlier: jnp.ndarray     # [N] bool per-edge inlier classification
    n_inliers: jnp.ndarray  # int32


def _stereo_residual_jac(R, t, xw, obs, fx, fy, cx, cy, bf):
    """Residual e = obs - h(R xw + t) and Jacobian de/dxi (xi = [v, w],
    left-multiplicative update exp(xi) * T like g2o VertexSE3Expmap).
    xw [N,3], obs [N,3] (u, v, uR).  Returns e [N,3], J [N,3,6], z [N]."""
    xc = jnp.einsum("ij,nj->ni", R, xw) + t
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    pred = jnp.stack([u, v, ur], axis=-1)
    e = obs - pred

    # d pred / d xc
    zero = jnp.zeros_like(x)
    Jp = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1),
        jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1),
        jnp.stack([fx * iz, zero, (-fx * x + bf) * iz2], axis=-1),
    ], axis=-2)                                              # [N, 3, 3]
    # d xc / d xi = [I | -hat(xc)]
    Jxc = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), (xw.shape[0], 3, 3)),
        -so3_hat(xc)], axis=-1)                              # [N, 3, 6]
    J = -jnp.einsum("nij,njk->nik", Jp, Jxc)                 # de/dxi
    return e, J, z


def _mono_residual_jac(R, t, xw, obs, fx, fy, cx, cy):
    xc = jnp.einsum("ij,nj->ni", R, xw) + t
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    pred = jnp.stack([fx * x * iz + cx, fy * y * iz + cy], axis=-1)
    e = obs - pred
    zero = jnp.zeros_like(x)
    Jp = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1),
        jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1),
    ], axis=-2)
    Jxc = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), (xw.shape[0], 3, 3)),
        -so3_hat(xc)], axis=-1)
    J = -jnp.einsum("nij,njk->nik", Jp, Jxc)
    return e, J, z


def pose_optimize(R0: jnp.ndarray, t0: jnp.ndarray,
                  xw: jnp.ndarray,          # [N, 3] fixed world points
                  obs: jnp.ndarray,         # [N, 3] (u, v, uR); uR < 0 => mono
                  inv_sigma2: jnp.ndarray,  # [N] per-edge information scale
                  valid: jnp.ndarray,       # [N] bool
                  fx, fy, cx, cy, bf,
                  huber_delta_mono: float = 2.447749,   # sqrt(5.991)
                  huber_delta_stereo: float = 2.795483,  # sqrt(7.815)
                  prior_w_rot=0.0, prior_w_trans=0.0
                  ) -> PoseOptResult:
    """All-array pose optimization.  Mono edges are rows with obs[:, 2] < 0.

    prior_w_rot / prior_w_trans (information weights, 1/sigma^2) add a weak
    SE3 prior anchoring the solution to the INIT pose (R0, t0).  Rationale:
    with the init coming from the constant-velocity motion model, scenes
    whose matched structure is depth-degenerate leave the camera's forward
    axis nearly unobservable (a 0.24 m axial slip moves a 25 m point 3 px
    and its stereo disparity 0.03 px); projection-only LM then settles
    wherever the prediction drops it and the slip compounds geometrically
    through the velocity model (measured -0.026 -> -0.068 -> -0.24 ->
    -0.80 m/frame, pure z, rot 0.00 deg).  A weak prior (sigma ~ 5 cm /
    0.05 rad per frame, w ~ 400) collapses only near-flat directions to the
    prediction: a single matched close point at 2 m contributes
    (fx*x/z^2)^2 ~ 4e3 px^2/m^2 of axial information and swamps it.  The
    reference has no such edge (Optimizer.cc:232-429) but never needs it at
    30 fps where prediction error is mm-scale; at the 2-5 fps dataset
    cadence this rebuild targets, the prior is what keeps weakly-observed
    directions bounded.  Pass 0 (default) for the exact reference protocol;
    tracking enables it only for the motion-model/local-map stages whose
    init IS the prediction (reloc and reference-KF tracking keep it off)."""
    is_stereo = obs[:, 2] >= 0.0
    dtype = R0.dtype
    # tangent ordering is [upsilon, omega] (translation, rotation)
    w_prior = jnp.concatenate([
        jnp.full((3,), prior_w_trans, dtype),
        jnp.full((3,), prior_w_rot, dtype)])
    Ri0, ti0 = se3_inverse(R0, t0)

    def prior_terms(R, t):
        # e = log(T * T0^-1): left-multiplicative offset from the anchor,
        # matching the update parametrization (J ~ I near the anchor)
        Rrel, trel = se3_compose(R, t, Ri0, ti0)
        e = se3_log(Rrel, trel)
        return e

    def chi2_of(R, t):
        e3, _, z3 = _stereo_residual_jac(R, t, xw, obs, fx, fy, cx, cy, bf)
        chi_s = jnp.sum(e3 * e3, axis=-1) * inv_sigma2
        e2, _, z2 = _mono_residual_jac(R, t, xw, obs[:, :2], fx, fy, cx, cy)
        chi_m = jnp.sum(e2 * e2, axis=-1) * inv_sigma2
        chi = jnp.where(is_stereo, chi_s, chi_m)
        depth_ok = jnp.where(is_stereo, z3, z2) > 0.0
        return chi, depth_ok

    def build_system(R, t, active, use_huber):
        e3, J3, _ = _stereo_residual_jac(R, t, xw, obs, fx, fy, cx, cy, bf)
        e2, J2, _ = _mono_residual_jac(R, t, xw, obs[:, :2], fx, fy, cx, cy)
        # unify: 3-dim residual with mono zero-padded third row
        e = jnp.where(is_stereo[:, None], e3,
                      jnp.concatenate([e2, jnp.zeros_like(e2[:, :1])], axis=-1))
        J = jnp.where(is_stereo[:, None, None], J3,
                      jnp.concatenate([J2, jnp.zeros_like(J2[:, :1, :])], axis=-2))
        chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
        delta = jnp.where(is_stereo, huber_delta_stereo, huber_delta_mono)
        sqrt_chi = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        w_huber = jnp.where(use_huber & (sqrt_chi > delta), delta / sqrt_chi, 1.0)
        w = inv_sigma2 * w_huber * active.astype(dtype)
        H = jnp.einsum("nik,n,nij->kj", J, w, J)
        b = -jnp.einsum("nik,n,ni->k", J, w, e)
        rho = jnp.where(use_huber & (sqrt_chi > delta),
                        2 * delta * sqrt_chi - delta * delta, chi2)
        rho = jnp.where(jnp.isfinite(rho), rho, 1e30)
        total = jnp.sum(rho * active.astype(dtype))
        ep = prior_terms(R, t)
        H = H + jnp.diag(w_prior)
        b = b - w_prior * ep
        total = total + jnp.sum(w_prior * ep * ep)
        return H, b, total

    def lm_round(R, t, active, use_huber):
        _, _, f0 = build_system(R, t, active, use_huber)
        lam0 = jnp.asarray(1e-5, dtype)   # multiplicative diag damping (g2o tau)

        def body(_, carry):
            R, t, lam, f_prev = carry
            H, b, _ = build_system(R, t, active, use_huber)
            # trace-scaled damping floor (like the BA drivers): the
            # closed-form inverse below loses more precision than a
            # pivoted solve on ill-conditioned H (low parallax, few
            # active edges), so keep the smallest eigenvalue bounded
            # away from zero relative to the system's scale
            floor = 1e-6 * jnp.trace(H) / 6.0 + 1e-9
            Hd = H + lam * jnp.diag(jnp.diag(H)) + floor * jnp.eye(6, dtype=dtype)
            # closed-form SPD 6x6 inverse: jnp.linalg.solve is an LU
            # custom-call (~0.1 ms of serial latency EACH; this loop runs
            # 40x inside the fused tracking step)
            dx = inv6x6(Hd) @ b
            dR, dt = se3_exp(dx)
            Rn, tn = se3_compose(dR, dt, R, t)
            _, _, f_new = build_system(Rn, tn, active, use_huber)
            better = f_new < f_prev
            R2 = jnp.where(better, Rn, R)
            t2 = jnp.where(better, tn, t)
            lam2 = jnp.where(better, lam * 0.5, lam * 4.0)
            f2 = jnp.where(better, f_new, f_prev)
            return (R2, t2, lam2, f2)

        R, t, _, _ = jax.lax.fori_loop(0, N_ITERS, body, (R, t, lam0, f0))
        return R, t

    R, t = R0, t0
    inlier = valid
    for rnd in range(N_ROUNDS):
        use_huber = jnp.asarray(rnd < 2)
        # never let behind-camera points poison the system (the reference
        # checks isDepthPositive between rounds; we also do it up front)
        _, depth_ok0 = chi2_of(R, t)
        active = inlier & valid & depth_ok0
        R, t = lm_round(R, t, active, use_huber)
        chi, depth_ok = chi2_of(R, t)
        th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = valid & (chi <= th) & depth_ok

    return PoseOptResult(R=R, t=t, inlier=inlier,
                         n_inliers=jnp.sum(inlier).astype(jnp.int32))
