"""Dynamic human-trajectory bundle adjustment — the AirDOS math core.

Behavioral rebuild of Optimizer::LocalBundleAdjustmentHumanTrajactory
(reference: src/Optimizer.cc:1496-2224) with the custom g2o types
(include/g2o_vertex_distance.h, g2o_edge_rigidbody.h, g2o_dyn_slam3d.h):

Vertices: local+fixed camera SE3s, static points, per-(pose, part) human
joint positions (14 body parts), per-(trajectory, part) scalar limb lengths,
per-trajectory SE(3) constant-velocity motion.
Edges:
- static stereo/mono projections (info = invSigma2 per octave),
- human-joint stereo projections from the pose's reference KF
  (info = SigmaHuman * I),
- ternary rigidity: | ||pA - pB|| - d |  (info = SigmaRigidity,
  Huber delta = thRanSacRigidity),
- ternary constant-velocity motion over consecutive poses x 5 torso joints:
  p1 - H_dt^{-1} p2, translation scaled by delta_t (info = SigmaMotion * I,
  Huber delta = thHuberMotion).
Protocol: phase-1 iterations with Huber -> chi-square deactivation
(7.815 projections / thRanSacRigidity / thRanSacMotion) -> phase-2 without
robust kernels -> outlier flags written back (bIsLost / bIsBad /
bOptimized semantics, Optimizer.cc:2076-2166).

Design: static landmarks are Schur-marginalised with 3x3 block
inverses (segment-sums); cameras + joints + limb lengths + motions form one
dense reduced system assembled by generic block-scatter of per-edge
J^T W J outer products — a few-thousand-dim dense solve, replacing g2o's
BlockSolverX + dense Cholesky.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from airdos_tpu.geometry.se3 import se3_compose, se3_exp, so3_exp, so3_hat
from airdos_tpu.solvers.smallmat import cho_solve_dense, inv3x3

CHI2_STEREO = 7.815
N_PARTS = 14
TORSO = (1, 2, 5, 11, 8)      # mainskleton (reference Map.h:48)


class HumanBAResult(NamedTuple):
    cam_R: jnp.ndarray        # [C, 3, 3]
    cam_t: jnp.ndarray        # [C, 3]
    points: jnp.ndarray       # [P, 3]
    joints: jnp.ndarray       # [T, L, 14, 3]
    seg_len: jnp.ndarray      # [T, 14]
    mot_R: jnp.ndarray        # [T, 3, 3]
    mot_t: jnp.ndarray        # [T, 3]  (velocity per unit time)
    static_inlier: jnp.ndarray   # [Es]
    key_inlier: jnp.ndarray      # [T, L, 14] projection-edge inlier
    rigid_inlier: jnp.ndarray    # [T, L, 14] per-pose segment inlier
    motion_inlier: jnp.ndarray   # [T, L-1, 5]  (pose l -> l+1)


def _proj_rj(Rc, tc, xw, obs, fx, fy, cx, cy, bf, is_stereo):
    """Stereo/mono projection residual + Jacobians (camera xi, point)."""
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
    e = jnp.where(is_stereo[:, None], e, e.at[:, 2].set(0.0))
    zero = jnp.zeros_like(x)
    Jp3 = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1),
        jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1),
        jnp.stack([fx * iz, zero, (-fx * x + bf) * iz2], axis=-1),
    ], axis=-2)
    Jp3 = jnp.where(is_stereo[:, None, None], Jp3, Jp3.at[:, 2, :].set(0.0))
    E = xw.shape[0]
    Jxc = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3, dtype=xw.dtype), (E, 3, 3)),
        -so3_hat(xc)], axis=-1)
    Jc = -jnp.einsum("eij,ejk->eik", Jp3, Jxc)       # [E, 3, 6]
    Jx = -jnp.einsum("eij,ejk->eik", Jp3, Rc)        # [E, 3, 3]
    return e, Jc, Jx, z


def human_bundle_adjust(
        cam_R, cam_t, cam_fixed,                  # [C,...]
        points, point_valid,                      # [P, 3] static
        es_cam, es_pt, es_obs, es_info, es_valid,  # static edges [Es]
        joints,                                   # [T, L, 14, 3]
        joint_exists,                             # [T, L, 14] vertex exists
        jo_cam,                                   # [T, L] observing cam (-1 none)
        jo_obs,                                   # [T, L, 14, 3] (u, v, uR)
        jo_valid,                                 # [T, L, 14] has projection edge
        seg_len, seg_free, seg_edge_valid,        # [T,14],[T,14],[T,L,14]
        mot_R, mot_t, traj_valid,                 # [T,...]
        pose_dt,                                  # [T, L] dt from pose l to l+1 (last unused)
        motion_edge_valid,                        # [T, L, 5] pose l->l+1 for torso joints
        sigma_static, sigma_human, sigma_rigidity, sigma_motion,
        th_huber_motion, th_ransac_motion, th_ransac_rigidity,
        fx, fy, cx, cy, bf,
        use_huber=True,
        iters1: int = 5, iters2: int = 10,
        axis_name: str | None = None) -> HumanBAResult:
    """With ``axis_name`` set (under shard_map), the STATIC edge tables
    (es_*) are shard-local: every static-edge reduction — the Schur blocks
    Hpp/bp/Hcc/bc/Wagg, the landmark back-substitution, and the static cost
    term — is psum-reduced over the mesh.  The human families (projection /
    rigidity / motion, a few thousand small edges) and the dense reduced
    solve run replicated: the human problem is dense and tiny next to the
    static window, so only the O(Es) work is worth distributing."""
    dtype = points.dtype

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x
    C = cam_R.shape[0]
    P = points.shape[0]
    T, L = joints.shape[0], joints.shape[1]
    NJ = T * L * N_PARTS
    D = 6 * C + 3 * NJ + N_PARTS * T + 6 * T
    off_j = 6 * C
    off_d = off_j + 3 * NJ
    off_m = off_d + N_PARTS * T

    body1 = jnp.asarray([1, 1, 2, 3, 1, 5, 6, 2, 8, 9, 5, 11, 12, 1], jnp.int32)
    body2 = jnp.asarray([0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 1], jnp.int32)
    torso = jnp.asarray(TORSO, jnp.int32)

    # flat joint index helpers -----------------------------------------
    def jidx(t, l, k):
        return (t * L + l) * N_PARTS + k

    tt = jnp.arange(T)[:, None, None]
    ll = jnp.arange(L)[None, :, None]
    kk = jnp.arange(N_PARTS)[None, None, :]

    # --- human projection edges (flattened [T*L*14]) -------------------
    hp_cam = jnp.broadcast_to(jo_cam[:, :, None], (T, L, N_PARTS)).reshape(-1)
    hp_joint = jidx(tt, ll, kk).reshape(-1)
    hp_obs = jo_obs.reshape(-1, 3)
    hp_valid = (jo_valid & joint_exists & (jo_cam[:, :, None] >= 0)).reshape(-1)
    hp_cam_safe = jnp.maximum(hp_cam, 0)

    # --- rigidity edges [T*L*14] ---------------------------------------
    rg_j1 = jidx(tt, ll, body1[None, None, :]).reshape(-1)
    rg_j2 = jidx(tt, ll, body2[None, None, :]).reshape(-1)
    rg_seg = (tt * N_PARTS + kk).reshape(T, 1, N_PARTS).repeat(L, 1).reshape(-1)
    j1_ok = jnp.take_along_axis(joint_exists, body1[None, None, :].repeat(L, 1).repeat(T, 0), axis=2)
    j2_ok = jnp.take_along_axis(joint_exists, body2[None, None, :].repeat(L, 1).repeat(T, 0), axis=2)
    rg_valid = (seg_edge_valid & j1_ok & j2_ok).reshape(-1)

    # --- motion edges [T*(L-1)*5] --------------------------------------
    lm = jnp.arange(L - 1)[None, :, None]
    mo_j1 = jidx(jnp.arange(T)[:, None, None], lm, torso[None, None, :]).reshape(-1)
    mo_j2 = jidx(jnp.arange(T)[:, None, None], lm + 1, torso[None, None, :]).reshape(-1)
    mo_traj = jnp.broadcast_to(jnp.arange(T)[:, None, None], (T, L - 1, 5)).reshape(-1)
    mo_dt = jnp.broadcast_to(pose_dt[:, :L - 1, None], (T, L - 1, 5)).reshape(-1)
    j1e = jnp.take_along_axis(joint_exists, torso[None, None, :].repeat(L, 1).repeat(T, 0), axis=2)
    mo_valid = (motion_edge_valid[:, :L - 1, :] &
                j1e[:, :L - 1, :] & j1e[:, 1:, :]).reshape(-1) & \
        jnp.broadcast_to(traj_valid[:, None, None], (T, L - 1, 5)).reshape(-1)

    # free mask over x ---------------------------------------------------
    free = jnp.ones((D,), bool)
    cam_free_rows = jnp.repeat(~cam_fixed, 6)
    free = free.at[:6 * C].set(cam_free_rows)
    joint_free = jnp.repeat(joint_exists.reshape(-1), 3)
    free = free.at[off_j:off_d].set(joint_free)
    free = free.at[off_d:off_m].set(seg_free.reshape(-1))
    # translation-only motion updates: the reference's
    # LandmarkMotionTernaryEdge Jacobian is zero wrt the rotation block
    # (g2o_dyn_slam3d.h:88-100), and rotation of a world-frame motion is
    # gauge-degenerate with translation for far-from-origin skeletons.
    mot_free = jnp.repeat(traj_valid, 6)
    rot_dims = (jnp.arange(6 * traj_valid.shape[0]) % 6) >= 3
    mot_free = mot_free & ~rot_dims
    free = free.at[off_m:].set(mot_free)
    freef = free.astype(dtype)

    is_stereo_s = es_obs[:, 2] >= 0
    delta_s = jnp.where(is_stereo_s, 2.795483, 2.447749)
    huber_h = jnp.asarray(2.795483, dtype)     # human keys use stereo chi2

    # ------------------------------------------------------------------
    def residuals(camR, camt, pts, jnts, segs, mR, mt):
        """Return residual/jacobian pieces for every family."""
        out = {}
        # static
        Rc = camR[es_cam]
        tc = camt[es_cam]
        e, Jc, Jx, z = _proj_rj(Rc, tc, pts[es_pt], es_obs, fx, fy, cx, cy, bf,
                                is_stereo_s)
        out["s"] = (e, Jc, Jx, z)
        # human projections
        jflat = jnts.reshape(-1, 3)
        Rh = camR[hp_cam_safe]
        th = camt[hp_cam_safe]
        is_st_h = hp_obs[:, 2] >= 0
        eh, Jch, Jxh, zh = _proj_rj(Rh, th, jflat[hp_joint], hp_obs,
                                    fx, fy, cx, cy, bf, is_st_h)
        out["h"] = (eh, Jch, Jxh, zh)
        # rigidity
        p1 = jflat[rg_j1]
        p2 = jflat[rg_j2]
        diff = p1 - p2
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-12)
        er = dist - segs.reshape(-1)[rg_seg]
        Jr = diff / dist[:, None]                      # d er / d p1; -Jr for p2
        out["r"] = (er, Jr)
        # motion: e = p1 - Hdt^{-1} p2, Hdt = (R, t*dt)
        Rm = mR[mo_traj]
        tm = mt[mo_traj] * mo_dt[:, None]
        p1m = jflat[mo_j1]
        p2m = jflat[mo_j2]
        xm = jnp.einsum("eji,ej->ei", Rm, p2m - tm)    # R^T (p2 - t)
        em = p1m - xm
        out["m"] = (em, Rm, xm)
        return out

    def cost(camR, camt, pts, jnts, segs, mR, mt, act, use_huber):
        res = residuals(camR, camt, pts, jnts, segs, mR, mt)
        e, _, _, _ = res["s"]
        chi_s = jnp.sum(e * e, -1) * es_info * sigma_static
        eh, _, _, _ = res["h"]
        chi_h = jnp.sum(eh * eh, -1) * sigma_human
        er, _ = res["r"]
        chi_r = er * er * sigma_rigidity
        em, _, _ = res["m"]
        chi_m = jnp.sum(em * em, -1) * sigma_motion

        def rho(chi, delta):
            sq = jnp.sqrt(jnp.maximum(chi, 1e-12))
            r = jnp.where(use_huber & (sq > delta), 2 * delta * sq - delta * delta, chi)
            return jnp.where(jnp.isfinite(r), r, 1e30)

        tot = (psum(jnp.sum(rho(chi_s, delta_s) * act["s"])) +
               jnp.sum(rho(chi_h, huber_h) * act["h"]) +
               jnp.sum(rho(chi_r, jnp.asarray(th_ransac_rigidity, dtype)) * act["r"]) +
               jnp.sum(rho(chi_m, jnp.asarray(th_huber_motion, dtype)) * act["m"]))
        return tot

    def chi2s(camR, camt, pts, jnts, segs, mR, mt):
        res = residuals(camR, camt, pts, jnts, segs, mR, mt)
        e, _, _, z = res["s"]
        chi_s = jnp.sum(e * e, -1) * es_info * sigma_static
        eh, _, _, zh = res["h"]
        chi_h = jnp.sum(eh * eh, -1) * sigma_human
        er, _ = res["r"]
        chi_r = er * er * sigma_rigidity
        em, _, _ = res["m"]
        chi_m = jnp.sum(em * em, -1) * sigma_motion
        return chi_s, z, chi_h, zh, chi_r, chi_m

    def gn_step(camR, camt, pts, jnts, segs, mR, mt, act, lam, use_huber):
        res = residuals(camR, camt, pts, jnts, segs, mR, mt)
        H = jnp.zeros((D, D), dtype)
        b = jnp.zeros((D,), dtype)

        def hw(chi, delta, base_w, active):
            sq = jnp.sqrt(jnp.maximum(chi, 1e-12))
            w_h = jnp.where(use_huber & (sq > delta), delta / sq, 1.0)
            return base_w * w_h * active

        # ---- static edges: Schur into the camera block ----------------
        e, Jc, Jx, _ = res["s"]
        chi_s = jnp.sum(e * e, -1) * es_info * sigma_static
        w_s = hw(chi_s, delta_s, es_info * sigma_static, act["s"])
        Hpp = psum(jnp.zeros((P, 3, 3), dtype).at[es_pt].add(
            jnp.einsum("eik,e,eil->ekl", Jx, w_s, Jx)))
        bp = psum(jnp.zeros((P, 3), dtype).at[es_pt].add(
            -jnp.einsum("eik,e,ei->ek", Jx, w_s, e)))
        Wcp = jnp.einsum("eik,e,eil->ekl", Jc, w_s, Jx)
        Hpp = Hpp + (lam * jnp.eye(3, dtype=dtype))[None] * \
            jnp.maximum(jnp.trace(Hpp, axis1=1, axis2=2)[:, None, None] / 3.0, 1e-3)
        Hpp = Hpp + 1e-6 * jnp.eye(3, dtype=dtype)[None]
        Hpp_inv = jnp.where(point_valid[:, None, None], inv3x3(Hpp), 0.0)
        Hcc = psum(jnp.zeros((C, 6, 6), dtype).at[es_cam].add(
            jnp.einsum("eik,e,eil->ekl", Jc, w_s, Jc)))
        bc = psum(jnp.zeros((C, 6), dtype).at[es_cam].add(
            -jnp.einsum("eik,e,ei->ek", Jc, w_s, e)))
        Wagg = psum(jnp.zeros((P, C, 6, 3), dtype).at[es_pt, es_cam].add(Wcp))
        Aagg = jnp.einsum("pckl,plm->pckm", Wagg, Hpp_inv)
        S_corr = jnp.einsum("pikm,pjlm->ijkl", Aagg, Wagg)
        b_corr = jnp.einsum("pckm,pm->ck", Aagg, bp)
        # scatter cam block into dense H
        ci = (jnp.arange(C)[:, None] * 6 + jnp.arange(6)[None, :])  # [C, 6]
        H = H.at[ci[:, None, :, None], ci[None, :, None, :]].add(
            -S_corr.transpose(0, 1, 2, 3))
        H = H.at[ci[:, :, None], ci[:, None, :]].add(Hcc)
        b = b.at[ci].add(bc - b_corr)

        # ---- generic block scatter helper -----------------------------
        def scatter(gidx, Jl, w, el):
            """gidx [E, q] global coords; Jl [E, r, q]; w [E]; el [E, r]."""
            JtWJ = jnp.einsum("erq,e,erp->eqp", Jl, w, Jl)
            Jtwe = -jnp.einsum("erq,e,er->eq", Jl, w, el)
            H2 = H.at[gidx[:, :, None], gidx[:, None, :]].add(JtWJ)
            b2 = b.at[gidx].add(Jtwe)
            return H2, b2

        # ---- human projection: vars = cam(6) + joint(3) ---------------
        eh, Jch, Jxh, _ = res["h"]
        chi_h = jnp.sum(eh * eh, -1) * sigma_human
        w_h = hw(chi_h, huber_h, jnp.full_like(chi_h, sigma_human), act["h"])
        g_cam = hp_cam_safe[:, None] * 6 + jnp.arange(6)[None, :]
        g_jnt = off_j + hp_joint[:, None] * 3 + jnp.arange(3)[None, :]
        gidx = jnp.concatenate([g_cam, g_jnt], axis=1)           # [E, 9]
        Jl = jnp.concatenate([Jch, Jxh], axis=2)                 # [E, 3, 9]
        H, b = scatter(gidx, Jl, w_h, eh)

        # ---- rigidity: vars = j1(3) + j2(3) + dist(1) -----------------
        er, Jr = res["r"]
        chi_r = er * er * sigma_rigidity
        w_r = hw(chi_r, jnp.asarray(th_ransac_rigidity, dtype),
                 jnp.full_like(chi_r, sigma_rigidity), act["r"])
        g1 = off_j + rg_j1[:, None] * 3 + jnp.arange(3)[None, :]
        g2 = off_j + rg_j2[:, None] * 3 + jnp.arange(3)[None, :]
        gd = off_d + rg_seg[:, None]
        gidx = jnp.concatenate([g1, g2, gd], axis=1)             # [E, 7]
        Jl = jnp.concatenate([Jr, -Jr, -jnp.ones_like(er)[:, None]], axis=1)[:, None, :]
        H, b = scatter(gidx, Jl, w_r, er[:, None])

        # ---- motion: vars = j1(3) + j2(3) + motion(6) -----------------
        em, Rm, xm = res["m"]
        chi_m = jnp.sum(em * em, -1) * sigma_motion
        w_m = hw(chi_m, jnp.asarray(th_huber_motion, dtype),
                 jnp.full_like(chi_m, sigma_motion), act["m"])
        E_m = em.shape[0]
        eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (E_m, 3, 3))
        RmT = jnp.swapaxes(Rm, 1, 2)
        # d em / d t_H = + R^T * dt ; d em / d omega_H = -[xm]x (right pert.)
        Jm_t = RmT * mo_dt[:, None, None]
        Jm_w = -so3_hat(xm)
        Jl = jnp.concatenate([eye3, -RmT, Jm_t, Jm_w], axis=2)   # [E, 3, 12]
        g1 = off_j + mo_j1[:, None] * 3 + jnp.arange(3)[None, :]
        g2 = off_j + mo_j2[:, None] * 3 + jnp.arange(3)[None, :]
        gm = off_m + mo_traj[:, None] * 6 + jnp.arange(6)[None, :]
        gidx = jnp.concatenate([g1, g2, gm], axis=1)             # [E, 12]
        H, b = scatter(gidx, Jl, w_m, em)

        # ---- freeze + damp + solve ------------------------------------
        H = H * freef[:, None] * freef[None, :]
        H = H + jnp.diag(1.0 - freef)
        b = b * freef
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(D, dtype=dtype)
        dx = cho_solve_dense(Hd, b)
        dx = dx * freef

        # ---- apply updates --------------------------------------------
        dxc = dx[:6 * C].reshape(C, 6)
        dR, dt = se3_exp(dxc)
        camR2, camt2 = se3_compose(dR, dt, camR, camt)
        jnts2 = jnts + dx[off_j:off_d].reshape(T, L, N_PARTS, 3)
        segs2 = segs + dx[off_d:off_m].reshape(T, N_PARTS)
        dmot = dx[off_m:].reshape(T, 6)
        mt2 = mt + dmot[:, :3]
        mR2 = jnp.matmul(mR, so3_exp(dmot[:, 3:]), precision="highest")

        # static point back-substitution
        WTdx = psum(jnp.zeros((P, 3), dtype).at[es_pt].add(
            jnp.einsum("ekl,ek->el", Wcp, dxc[es_cam])))
        dxp = jnp.einsum("plm,pm->pl", Hpp_inv, bp - WTdx)
        pts2 = pts + dxp * point_valid[:, None].astype(dtype)
        return camR2, camt2, pts2, jnts2, segs2, mR2, mt2

    def run_phase(state, act, n_iters, use_huber):
        def body(_, carry):
            (camR, camt, pts, jnts, segs, mR, mt, lam, f_prev) = carry
            new = gn_step(camR, camt, pts, jnts, segs, mR, mt, act, lam, use_huber)
            f_new = cost(*new, act, use_huber)
            better = f_new < f_prev
            sel = lambda a, bb: jnp.where(better, a, bb)
            out = tuple(sel(n, o) for n, o in zip(new, (camR, camt, pts, jnts, segs, mR, mt)))
            lam2 = jnp.where(better, lam * 0.3, lam * 8.0)
            f2 = jnp.where(better, f_new, f_prev)
            return (*out, lam2, f2)

        f0 = cost(*state, act, use_huber)
        carry = (*state, jnp.asarray(1e-6, dtype), f0)
        carry = jax.lax.fori_loop(0, n_iters, body, carry)
        return carry[:7]

    act1 = {"s": (es_valid & point_valid[es_pt]).astype(dtype),
            "h": hp_valid.astype(dtype),
            "r": rg_valid.astype(dtype),
            "m": mo_valid.astype(dtype)}
    # Optimizer.IsHuber gates the phase-1 robust kernel (reference
    # Tracking.cc:150 reads the flag; the human-BA edges install
    # RobustKernelHuber only when set, Optimizer.cc:1599-1616)
    state = (cam_R, cam_t, points, joints, seg_len, mot_R, mot_t)
    state = run_phase(state, act1, iters1, jnp.asarray(use_huber))

    chi_s, z_s, chi_h, z_h, chi_r, chi_m = chi2s(*state)
    s_in = es_valid & point_valid[es_pt] & (chi_s <= CHI2_STEREO) & (z_s > 0)
    h_in = hp_valid & (chi_h <= CHI2_STEREO) & (z_h > 0)
    r_in = rg_valid & (chi_r <= th_ransac_rigidity)
    m_in = mo_valid & (chi_m <= th_ransac_motion)
    act2 = {"s": s_in.astype(dtype), "h": h_in.astype(dtype),
            "r": r_in.astype(dtype), "m": m_in.astype(dtype)}
    state = run_phase(state, act2, iters2, jnp.asarray(False))

    chi_s, z_s, chi_h, z_h, chi_r, chi_m = chi2s(*state)
    s_in = es_valid & point_valid[es_pt] & (chi_s <= CHI2_STEREO) & (z_s > 0)
    h_in = hp_valid & (chi_h <= CHI2_STEREO) & (z_h > 0)
    r_in = rg_valid & (chi_r <= th_ransac_rigidity)
    m_in = mo_valid & (chi_m <= th_ransac_motion)

    camR, camt, pts, jnts, segs, mR, mt = state
    return HumanBAResult(
        cam_R=camR, cam_t=camt, points=pts, joints=jnts, seg_len=segs,
        mot_R=mR, mot_t=mt,
        static_inlier=s_in,
        key_inlier=h_in.reshape(T, L, N_PARTS),
        rigid_inlier=r_in.reshape(T, L, N_PARTS),
        motion_inlier=m_in.reshape(T, L - 1, 5))
