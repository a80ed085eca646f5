"""Full-map bundle adjustment at map scale (matrix-free Schur + PCG).

Behavioral rebuild of Optimizer::BundleAdjustment / GlobalBundleAdjustemnt
(reference: src/Optimizer.cc:52-230): every keyframe (first fixed) and every
live map point, stereo/mono projection edges, Huber phase then a polish
phase with chi2-gated outliers, write-back of all poses and points.

Design (replaces g2o's sparse Cholesky):
- The dense-Schur local solver (solvers/local_ba.py) materialises the
  per-point camera coupling [P, C, 6, 3]; at map scale (hundreds of KFs,
  10^5 points) that array and the C^2 Schur product are infeasible.
- Here the reduced camera system S = Hcc - W Hpp^-1 W^T is never formed.
  Each (point, camera) pair has at most ONE edge, so W's nonzero blocks
  ARE the edge table: S @ x is three O(E) gather/scatter contractions.
  The solve is preconditioned CG with the exact 6x6 block diagonal of S
  (also one O(E) scatter) — the textbook sparse-BA-on-accelerator layout.
- Memory is O(E + P + C); compute per CG step is O(E) fused einsums.
- Multi-chip: pass ``axis_name`` under shard_map with edge tables sharded;
  every edge reduction (scatters into C/P tables, CG dot products) is
  psum-reduced over the mesh and the CG state stays replicated.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.geometry.se3 import se3_compose, se3_exp
from airdos_tpu.solvers.local_ba import (CHI2_MONO, CHI2_STEREO,
                                         _proj_residual)
from airdos_tpu.solvers.smallmat import inv3x3, inv6x6


class GlobalBAResult(NamedTuple):
    R: jnp.ndarray            # [C, 3, 3]
    t: jnp.ndarray            # [C, 3]
    points: jnp.ndarray       # [P, 3]
    edge_inlier: jnp.ndarray  # [E] bool


def global_bundle_adjust(
        cam_R: jnp.ndarray,       # [C, 3, 3] Tcw rotations
        cam_t: jnp.ndarray,       # [C, 3]
        cam_fixed: jnp.ndarray,   # [C] bool
        points: jnp.ndarray,      # [P, 3]
        point_valid: jnp.ndarray,  # [P] bool
        e_cam: jnp.ndarray,       # [E] int32
        e_pt: jnp.ndarray,        # [E] int32
        e_obs: jnp.ndarray,       # [E, 3] (u, v, uR); uR < 0 -> mono
        e_info: jnp.ndarray,      # [E] invSigma2
        e_valid: jnp.ndarray,     # [E] bool
        fx, fy, cx, cy, bf,
        iters1: int = 6, iters2: int = 10, cg_iters: int = 48,
        axis_name: str | None = None) -> GlobalBAResult:
    C = cam_R.shape[0]
    P = points.shape[0]
    dtype = points.dtype
    is_stereo = e_obs[:, 2] >= 0
    delta_h = jnp.where(is_stereo, 2.795483, 2.447749)
    chi_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    cam_free = (~cam_fixed).astype(dtype)[:, None]           # [C, 1]

    def chi2_all(R, t, pts):
        e, _, _, z = _proj_residual(R[e_cam], t[e_cam], pts[e_pt], e_obs,
                                    fx, fy, cx, cy, bf, is_stereo)
        return jnp.sum(e * e, axis=-1) * e_info, z

    def gn_step(R, t, pts, active, lam, use_huber):
        e, Jc, Jp, _ = _proj_residual(R[e_cam], t[e_cam], pts[e_pt], e_obs,
                                      fx, fy, cx, cy, bf, is_stereo)
        chi2 = jnp.sum(e * e, axis=-1) * e_info
        sq = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        w_h = jnp.where(use_huber & (sq > delta_h), delta_h / sq, 1.0)
        w = (e_info * w_h * active).astype(dtype)

        # --- O(E) normal-equation pieces -------------------------------
        Hcc = psum(jnp.zeros((C, 6, 6), dtype).at[e_cam].add(
            jnp.einsum("eik,e,eil->ekl", Jc, w, Jc)))
        Hpp = psum(jnp.zeros((P, 3, 3), dtype).at[e_pt].add(
            jnp.einsum("eik,e,eil->ekl", Jp, w, Jp)))
        bc = psum(jnp.zeros((C, 6), dtype).at[e_cam].add(
            -jnp.einsum("eik,e,ei->ek", Jc, w, e)))
        bp = psum(jnp.zeros((P, 3), dtype).at[e_pt].add(
            -jnp.einsum("eik,e,ei->ek", Jp, w, e)))
        Wcp = jnp.einsum("eik,e,eil->ekl", Jc, w, Jp)        # [E, 6, 3]

        # damp + invert landmark blocks
        Hpp_d = Hpp + (lam * jnp.eye(3, dtype=dtype))[None] * \
            jnp.maximum(jnp.trace(Hpp, axis1=1, axis2=2)[:, None, None] / 3.0,
                        1e-3)
        Hpp_d = Hpp_d + 1e-6 * jnp.eye(3, dtype=dtype)[None]
        Hpp_inv = inv3x3(Hpp_d)
        Hpp_inv = jnp.where(point_valid[:, None, None], Hpp_inv, 0.0)

        # damped camera diagonal (Marquardt scaling on Hcc's diagonal)
        diag_scale = jnp.einsum("ckk->ck", Hcc)              # [C, 6]
        Hcc_d = Hcc + lam * jnp.einsum(
            "ck,kl->ckl", diag_scale, jnp.eye(6, dtype=dtype)) + \
            1e-6 * jnp.eye(6, dtype=dtype)[None]

        # reduced rhs: b_red = bc - W Hpp^-1 bp  (one gather + scatter)
        hb = jnp.einsum("plm,pm->pl", Hpp_inv, bp)           # [P, 3]
        b_red = bc - psum(jnp.zeros((C, 6), dtype).at[e_cam].add(
            jnp.einsum("ekl,el->ek", Wcp, hb[e_pt])))
        b_red = b_red * cam_free

        def schur_matvec(x):
            """S @ x without forming S: O(E) gathers/scatters."""
            x = x * cam_free
            y = jnp.einsum("ekl,ek->el", Wcp, x[e_cam])      # [E, 3]
            z = psum(jnp.zeros((P, 3), dtype).at[e_pt].add(y))
            z = jnp.einsum("plm,pm->pl", Hpp_inv, z)
            back = psum(jnp.zeros((C, 6), dtype).at[e_cam].add(
                jnp.einsum("ekl,el->ek", Wcp, z[e_pt])))
            Sx = jnp.einsum("ckl,cl->ck", Hcc_d, x) - back
            return Sx * cam_free + x * (1.0 - cam_free)

        # block-Jacobi preconditioner: exact 6x6 diagonal of S
        A_e = jnp.einsum("ekl,elm->ekm", Wcp, Hpp_inv[e_pt])  # [E, 6, 3]
        D_corr = psum(jnp.zeros((C, 6, 6), dtype).at[e_cam].add(
            jnp.einsum("ekm,elm->ekl", A_e, Wcp)))
        D = Hcc_d - D_corr
        D = D * cam_free[:, :, None] + \
            jnp.eye(6, dtype=dtype)[None] * (1.0 - cam_free[:, :, None])
        D_inv = inv6x6(D + 1e-6 * jnp.eye(6, dtype=dtype)[None])

        def precond(r):
            return jnp.einsum("ckl,cl->ck", D_inv, r)

        # --- preconditioned CG on the reduced camera system ------------
        x0 = jnp.zeros((C, 6), dtype)
        r0 = b_red
        z0 = precond(r0)
        p0 = z0
        rz0 = jnp.vdot(r0, z0)

        def cg_body(_, carry):
            x, r, p, rz = carry
            Ap = schur_matvec(p)
            pAp = jnp.vdot(p, Ap)
            alpha = jnp.where(jnp.abs(pAp) > 1e-20, rz / pAp, 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = jnp.vdot(r, z)
            beta = jnp.where(jnp.abs(rz) > 1e-20, rz_new / rz, 0.0)
            p = z + beta * p
            return (x, r, p, rz_new)

        dx_c, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body,
                                          (x0, r0, p0, rz0))
        dx_c = dx_c * cam_free

        # back-substitute points
        y = jnp.einsum("ekl,ek->el", Wcp, dx_c[e_cam])
        WTdx = psum(jnp.zeros((P, 3), dtype).at[e_pt].add(y))
        dx_p = jnp.einsum("plm,pm->pl", Hpp_inv, bp - WTdx)
        dx_p = dx_p * point_valid[:, None].astype(dtype)

        dR, dt = se3_exp(dx_c)
        Rn, tn = se3_compose(dR, dt, R, t)
        return Rn, tn, pts + dx_p

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
            return (jnp.where(better, Rn, R), jnp.where(better, tn, t),
                    jnp.where(better, pn, pts),
                    jnp.where(better, lam * 0.3, lam * 8.0),
                    jnp.where(better, f_new, f_prev))

        f0 = cost(R, t, pts)
        R, t, pts, _, _ = jax.lax.fori_loop(
            0, n_iters, body, (R, t, pts, jnp.asarray(1e-6, dtype), f0))
        return R, t, pts

    active0 = (e_valid & point_valid[e_pt]).astype(dtype)
    R, t, pts = run_phase(cam_R, cam_t, points, active0, iters1,
                          jnp.asarray(True))
    chi2, z = chi2_all(R, t, pts)
    inlier = e_valid & point_valid[e_pt] & (chi2 <= chi_th) & (z > 0)
    R, t, pts = run_phase(R, t, pts, inlier.astype(dtype), iters2,
                          jnp.asarray(False))
    chi2, z = chi2_all(R, t, pts)
    inlier = e_valid & point_valid[e_pt] & (chi2 <= chi_th) & (z > 0)
    return GlobalBAResult(R=R, t=t, points=pts, edge_inlier=inlier)
