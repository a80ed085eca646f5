"""Local bundle adjustment with on-device Schur complement.

Behavioral rebuild of Optimizer::LocalBundleAdjustment (reference:
src/Optimizer.cc:431-731): local keyframes + their map points + fixed
observer keyframes, stereo/mono projection edges, 5+10 LM iterations with a
chi-square outlier pass in between (5.991 mono / 7.815 stereo), Huber
kernel, outlier observations erased on write-back.

Design (replaces g2o's sparse CSparse/Eigen solve):
- The graph is three padded edge-table arrays (cam_idx, pt_idx, obs).
- Residuals/Jacobians evaluated for ALL edges at once (vmapped analytic
  forms).
- Gauss-Newton normal equations are reduced by marginalising every 3x3
  landmark block (Schur complement) via segment-sums; the reduced camera
  system (6C x 6C, C <= ~48) is solved densely on device.
- The 5+10-iteration protocol with mid-run outlier demotion is one jit.
- Multi-chip: pass ``axis_name`` and shard-local edge tables; every
  edge-reduction (normal-equation blocks, costs) is psum-reduced over the
  mesh axis, the small reduced solve runs replicated.  See
  parallel.sharded_ba.sharded_local_bundle_adjust for the shard_map wrapper.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.geometry.se3 import se3_compose, se3_exp, so3_hat
from airdos_tpu.solvers.smallmat import cho_solve_dense, inv3x3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class LocalBAResult(NamedTuple):
    R: jnp.ndarray          # [C, 3, 3] optimized camera rotations
    t: jnp.ndarray          # [C, 3]
    points: jnp.ndarray     # [P, 3] optimized landmark positions
    edge_inlier: jnp.ndarray  # [E] bool final classification


def _proj_residual(Rc, tc, xw, obs, fx, fy, cx, cy, bf, is_stereo):
    """Per-edge residual + Jacobians.  Rc [E,3,3], tc [E,3], xw [E,3].
    Returns e [E,3], Jc [E,3,6] (camera), Jp [E,3,3] (point), z [E]."""
    xc = jnp.einsum("eij,ej->ei", Rc, xw) + tc
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    pred = jnp.stack([u, v, ur], axis=-1)
    e = obs - pred
    e = jnp.where(is_stereo[:, None], e,
                  e.at[:, 2].set(0.0))

    zero = jnp.zeros_like(x)
    Jproj = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1),
        jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1),
        jnp.stack([fx * iz, zero, (-fx * x + bf) * iz2], axis=-1),
    ], axis=-2)                                             # [E, 3, 3]
    Jproj = jnp.where(is_stereo[:, None, None], Jproj,
                      Jproj.at[:, 2, :].set(0.0))
    E = xw.shape[0]
    Jxc_cam = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3, dtype=xw.dtype), (E, 3, 3)),
        -so3_hat(xc)], axis=-1)                             # [E, 3, 6]
    Jc = -jnp.einsum("eij,ejk->eik", Jproj, Jxc_cam)
    Jp = -jnp.einsum("eij,ejk->eik", Jproj, Rc)             # d e / d xw
    return e, Jc, Jp, z


def local_bundle_adjust(
        cam_R: jnp.ndarray,       # [C, 3, 3] Tcw rotations (local + fixed)
        cam_t: jnp.ndarray,       # [C, 3]
        cam_fixed: jnp.ndarray,   # [C] bool — fixed observers
        points: jnp.ndarray,      # [P, 3] world points
        point_valid: jnp.ndarray,  # [P] bool
        e_cam: jnp.ndarray,       # [E] int32 camera index per edge
        e_pt: jnp.ndarray,        # [E] int32 point index per edge
        e_obs: jnp.ndarray,       # [E, 3] (u, v, uR); uR < 0 -> mono
        e_info: jnp.ndarray,      # [E] invSigma2
        e_valid: jnp.ndarray,     # [E] bool
        fx, fy, cx, cy, bf,
        iters1: int = 5, iters2: int = 10,
        axis_name: str | None = None) -> LocalBAResult:
    C = cam_R.shape[0]
    P = points.shape[0]
    dtype = points.dtype
    is_stereo = e_obs[:, 2] >= 0
    delta_h = jnp.where(is_stereo, 2.795483, 2.447749)
    chi_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    def chi2_all(R, t, pts):
        Rc = R[e_cam]
        tc = t[e_cam]
        xw = pts[e_pt]
        e, _, _, z = _proj_residual(Rc, tc, xw, e_obs, fx, fy, cx, cy, bf, is_stereo)
        return jnp.sum(e * e, axis=-1) * e_info, z

    def gn_step(R, t, pts, active, lam, use_huber):
        Rc = R[e_cam]
        tc = t[e_cam]
        xw = pts[e_pt]
        e, Jc, Jp, _ = _proj_residual(Rc, tc, xw, e_obs, fx, fy, cx, cy, bf, is_stereo)
        chi2 = jnp.sum(e * e, axis=-1) * e_info
        sq = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        w_h = jnp.where(use_huber & (sq > delta_h), delta_h / sq, 1.0)
        w = (e_info * w_h * active).astype(dtype)

        cam_free = (~cam_fixed).astype(dtype)
        # --- assemble blocks via segment sums (psum over mesh shards) --
        Hcc = psum(jnp.zeros((C, 6, 6), dtype).at[e_cam].add(
            jnp.einsum("eik,e,eil->ekl", Jc, w, Jc)))
        Hpp = psum(jnp.zeros((P, 3, 3), dtype).at[e_pt].add(
            jnp.einsum("eik,e,eil->ekl", Jp, w, Jp)))
        bc = psum(jnp.zeros((C, 6), dtype).at[e_cam].add(
            -jnp.einsum("eik,e,ei->ek", Jc, w, e)))
        bp = psum(jnp.zeros((P, 3), dtype).at[e_pt].add(
            -jnp.einsum("eik,e,ei->ek", Jp, w, e)))
        # per-edge camera-point coupling W = Jc^T w Jp  [E, 6, 3]
        Wcp = jnp.einsum("eik,e,eil->ekl", Jc, w, Jp)

        # damp + invert landmark blocks
        Hpp = Hpp + (lam * jnp.eye(3, dtype=dtype))[None] * \
            jnp.maximum(jnp.trace(Hpp, axis1=1, axis2=2)[:, None, None] / 3.0, 1e-3)
        Hpp = Hpp + 1e-6 * jnp.eye(3, dtype=dtype)[None]
        Hpp_inv = inv3x3(Hpp)
        Hpp_inv = jnp.where(point_valid[:, None, None], Hpp_inv, 0.0)

        # Schur: S = Hcc - sum_e sum_e' W_e Hpp^-1 W_e'^T  (same point)
        # S couples cameras sharing a point: S[ci, cj] -= sum over point p of
        # (sum_{e in p, cam ci} W_e Hpp^-1) @ (sum_{e' in p, cam cj} W_e')^T.
        # Aggregate per (point, camera) via segment sums into [P, C, 6, 3];
        # with C small this stays dense-but-small and contraction-friendly:
        Wagg = psum(jnp.zeros((P, C, 6, 3), dtype).at[e_pt, e_cam].add(Wcp))
        Aagg = jnp.einsum("pckl,plm->pckm", Wagg, Hpp_inv)
        S_corr = jnp.einsum("pikm,pjlm->ijkl", Aagg, Wagg)   # [C, C, 6, 6]
        S = jnp.zeros((C, C, 6, 6), dtype)
        S = S.at[jnp.arange(C), jnp.arange(C)].set(Hcc)
        S = S - S_corr
        b_corr = jnp.einsum("pckm,pm->ck", Aagg, bp)
        b_red = bc - b_corr

        # freeze fixed cameras: identity rows/cols, zero rhs
        free_mask = cam_free[:, None, None, None] * cam_free[None, :, None, None]
        S = S * free_mask
        S = S.at[jnp.arange(C), jnp.arange(C)].add(
            (1.0 - cam_free)[:, None, None] * jnp.eye(6, dtype=dtype)[None])
        b_red = b_red * cam_free[:, None]

        # dense solve on the reduced system
        Sd = S.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)
        Sd = Sd + lam * jnp.diag(jnp.diag(Sd)) + 1e-6 * jnp.eye(6 * C, dtype=dtype)
        dx_c = cho_solve_dense(Sd, b_red.reshape(-1)).reshape(C, 6)
        dx_c = dx_c * cam_free[:, None]

        # back-substitute points: dx_p = Hpp^-1 (bp - sum_c Wagg_pc^T dx_c)
        # (Wagg is already psum-reduced, so this needs no extra collective)
        WTdx = jnp.einsum("pckl,ck->pl", Wagg, dx_c)
        dx_p = jnp.einsum("plm,pm->pl", Hpp_inv, bp - WTdx)
        dx_p = dx_p * point_valid[:, None].astype(dtype)

        dR, dt = se3_exp(dx_c)
        Rn, tn = se3_compose(dR, dt, R, t)
        pts_n = pts + dx_p
        return Rn, tn, pts_n

    def run_phase(R, t, pts, active, n_iters, use_huber):
        def cost(R, t, pts):
            chi2, _ = chi2_all(R, t, pts)
            sq = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            rho = jnp.where(use_huber & (sq > delta_h),
                            2 * delta_h * sq - delta_h * delta_h, chi2)
            rho = jnp.where(jnp.isfinite(rho), rho, 1e30)
            return psum(jnp.sum(rho * active))

        def body(_, carry):
            R, t, pts, lam, f_prev = carry
            Rn, tn, pn = gn_step(R, t, pts, active, lam, use_huber)
            f_new = cost(Rn, tn, pn)
            better = f_new < f_prev
            R2 = jnp.where(better, Rn, R)
            t2 = jnp.where(better, tn, t)
            p2 = jnp.where(better, pn, pts)
            lam2 = jnp.where(better, lam * 0.3, lam * 8.0)
            f2 = jnp.where(better, f_new, f_prev)
            return (R2, t2, p2, lam2, f2)

        f0 = cost(R, t, pts)
        R, t, pts, _, _ = jax.lax.fori_loop(
            0, n_iters, body, (R, t, pts, jnp.asarray(1e-6, dtype), f0))
        return R, t, pts

    active0 = (e_valid & point_valid[e_pt]).astype(dtype)
    R, t, pts = run_phase(cam_R, cam_t, points, active0, iters1, jnp.asarray(True))
    chi2, z = chi2_all(R, t, pts)
    inlier = e_valid & point_valid[e_pt] & (chi2 <= chi_th) & (z > 0)
    R, t, pts = run_phase(R, t, pts, inlier.astype(dtype), iters2, jnp.asarray(False))
    chi2, z = chi2_all(R, t, pts)
    inlier = e_valid & point_valid[e_pt] & (chi2 <= chi_th) & (z > 0)
    return LocalBAResult(R=R, t=t, points=pts, edge_inlier=inlier)
