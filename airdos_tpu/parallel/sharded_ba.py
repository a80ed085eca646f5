"""Multi-device sharded optimization steps.

The reference is single-node (its only parallelism is 4 OS threads,
System.cc:87-96).  The scaling axis for this workload is edge-parallel
bundle adjustment and hypothesis-parallel RANSAC over a 1-D device mesh:
each device evaluates residuals/Jacobians for its shard of the edge table,
the tiny normal-equation system is psum-reduced over the mesh, and the
solve + state update happen replicated.  Communication is O(dim^2) per
iteration (a few KB) regardless of edge count.  On one host the cards are
joined all to all by NVLink, so the mesh follows the algorithm alone; XLA
hands the collectives to NCCL.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from airdos_tpu.geometry.se3 import se3_compose, se3_exp, so3_hat


def make_mesh(n_devices: int | None = None, axis: str = "edges") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are visible: {devs}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _stereo_system(R, t, xw, obs, w, fx, fy, cx, cy, bf):
    """Edge-shard H (6x6) and b (6) for pose-only GN."""
    xc = jnp.einsum("ij,nj->ni", R, xw) + t
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    pred = jnp.stack([fx * x * iz + cx, fy * y * iz + cy,
                      fx * x * iz + cx - bf * iz], axis=-1)
    e = obs - pred
    zero = jnp.zeros_like(x)
    Jp = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1),
        jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1),
        jnp.stack([fx * iz, zero, (-fx * x + bf) * iz2], axis=-1),
    ], axis=-2)
    Jxc = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), (xw.shape[0], 3, 3)),
        -so3_hat(xc)], axis=-1)
    J = -jnp.einsum("nij,njk->nik", Jp, Jxc)
    H = jnp.einsum("nik,n,nij->kj", J, w, J)
    b = -jnp.einsum("nik,n,ni->k", J, w, e)
    return H, b


def sharded_pose_optimize_step(mesh: Mesh, axis: str = "edges"):
    """Returns a jitted function (R, t, xw, obs, w) -> (R', t') performing
    one Gauss-Newton step with the edge table sharded over the mesh and the
    6x6 system psum-reduced over the mesh."""

    def step(R, t, xw, obs, w, fx, fy, cx, cy, bf):
        def shard_fn(R, t, xw_s, obs_s, w_s):
            H, b = _stereo_system(R, t, xw_s, obs_s, w_s, fx, fy, cx, cy, bf)
            H = jax.lax.psum(H, axis)
            b = jax.lax.psum(b, axis)
            dx = jnp.linalg.solve(H + 1e-6 * jnp.eye(6, dtype=R.dtype), b)
            dR, dt = se3_exp(dx)
            return se3_compose(dR, dt, R, t)

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P(axis)),
            out_specs=(P(), P()))(R, t, xw, obs, w)

    return jax.jit(step, static_argnames=())


def sharded_local_bundle_adjust(mesh: Mesh, axis: str = "edges",
                                iters1: int = 5, iters2: int = 10):
    """The FULL local-BA LM protocol (solvers.local_ba.local_bundle_adjust:
    two phases, Huber, mid-run chi2 outlier demotion, Schur complement with
    landmark back-substitution) with the edge table sharded over the mesh.

    Each device evaluates residuals/Jacobians and partial normal-equation
    blocks for its edge shard; Hcc/Hpp/bc/bp/Wagg and the LM costs are
    psum-reduced over the mesh; the small reduced camera solve and the landmark
    back-substitution run replicated.  Per-iteration communication is
    O(P*C) block aggregates — a few MB over the interconnect, independent of edge
    count.  Edge arrays must be padded to a multiple of the mesh size
    (invalid rows flagged via e_valid=False).

    Returns a jitted fn with the same signature/result as
    local_bundle_adjust (edge_inlier comes back gathered to full length)."""
    from airdos_tpu.solvers.local_ba import local_bundle_adjust

    def run(cam_R, cam_t, cam_fixed, points, point_valid,
            e_cam, e_pt, e_obs, e_info, e_valid, fx, fy, cx, cy, bf):
        def shard_fn(cam_R, cam_t, cam_fixed, points, point_valid,
                     e_cam_s, e_pt_s, e_obs_s, e_info_s, e_valid_s):
            return local_bundle_adjust(
                cam_R, cam_t, cam_fixed, points, point_valid,
                e_cam_s, e_pt_s, e_obs_s, e_info_s, e_valid_s,
                fx, fy, cx, cy, bf,
                iters1=iters1, iters2=iters2, axis_name=axis)

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(),
                      P(axis), P(axis), P(axis), P(axis), P(axis)),
            out_specs=_ba_out_specs(axis),
        )(cam_R, cam_t, cam_fixed, points, point_valid,
          e_cam, e_pt, e_obs, e_info, e_valid)

    return jax.jit(run)


def _ba_out_specs(axis):
    from airdos_tpu.solvers.local_ba import LocalBAResult
    return LocalBAResult(R=P(), t=P(), points=P(), edge_inlier=P(axis))


def sharded_epnp_ransac(mesh: Mesh, axis: str = "edges"):
    """Hypothesis-parallel EPnP RANSAC over the device mesh (SURVEY §2c's
    second scaling axis).  The [H, 4] minimal-sample table is sharded over
    the mesh: every device runs the vmapped EPnP + inlier count for its
    hypothesis shard, the per-device best (count, R, t) triples are
    all-gathered (a few hundred bytes), the global winner is
    selected replicated, and the weighted-EPnP refine on the winner's
    inlier set runs replicated.  Bitwise-identical to the single-chip
    solvers.epnp.epnp_ransac for the same sample table.

    H must be a multiple of the mesh size.  Returns a jitted fn with the
    PnPRansacResult signature."""
    from airdos_tpu.solvers.epnp import PnPRansacResult, epnp_pose

    def run(pw, uv, valid, max_err2, sample_idx, fx, fy, cx, cy):
        def shard_fn(pw, uv, valid, max_err2, samples_s):
            def one_hyp(idx):
                w = jnp.ones(4, pw.dtype)
                R, t = epnp_pose(pw[idx], uv[idx], w, fx, fy, cx, cy)
                xc = pw @ R.T + t
                z = jnp.where(jnp.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
                u = fx * xc[:, 0] / z + cx
                v = fy * xc[:, 1] / z + cy
                err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
                inl = valid & (err2 < max_err2) & (z > 0)
                return R, t, jnp.sum(inl)

            Rs, ts, counts = jax.vmap(one_hyp)(samples_s)
            k = jnp.argmax(counts)
            # gather each device's champion, pick the global one
            c_all = jax.lax.all_gather(counts[k], axis)      # [D]
            R_all = jax.lax.all_gather(Rs[k], axis)          # [D, 3, 3]
            t_all = jax.lax.all_gather(ts[k], axis)          # [D, 3]
            g = jnp.argmax(c_all)
            R_b, t_b = R_all[g], t_all[g]

            def inliers_of(R, t):
                xc = pw @ R.T + t
                z = jnp.where(jnp.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
                u = fx * xc[:, 0] / z + cx
                v = fy * xc[:, 1] / z + cy
                err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
                return valid & (err2 < max_err2) & (z > 0)

            inl_b = inliers_of(R_b, t_b)
            # replicated refine on the winning inlier set (same protocol
            # as the single-chip epnp_ransac)
            w_ref = inl_b.astype(pw.dtype)
            R_r, t_r = epnp_pose(pw, uv, w_ref + 1e-6, fx, fy, cx, cy)
            inl_r = inliers_of(R_r, t_r)
            better = jnp.sum(inl_r) >= jnp.sum(inl_b)
            R_f = jnp.where(better, R_r, R_b)
            t_f = jnp.where(better, t_r, t_b)
            inl_f = jnp.where(better, inl_r, inl_b)
            return PnPRansacResult(R=R_f, t=t_f, inliers=inl_f,
                                   n_inliers=jnp.sum(inl_f))

        # check_vma=False: outputs ARE replicated (everything after the
        # all_gather is computed identically on every device) but the
        # argmax-select defeats static replication inference
        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(axis)),
            out_specs=PnPRansacResult(R=P(), t=P(), inliers=P(),
                                      n_inliers=P()),
            check_vma=False)(
            pw, uv, valid, max_err2, sample_idx)

    return jax.jit(run)


def sharded_sim3_ransac(mesh: Mesh, axis: str = "edges",
                        fix_scale: bool = True):
    """Hypothesis-parallel Sim3 RANSAC over the device mesh (loop closure's
    ComputeSim3, reference Sim3Solver::iterate): the [H, 3] minimal-sample
    table is sharded over the mesh, each device runs vmapped Horn
    alignments + mutual-reprojection inlier counts for its shard, the
    per-device best (count, R, t, s) is all-gathered (a few hundred bytes
    over the mesh), and the winner's inlier-weighted Horn refine runs
    replicated — the same champion-vote shape as sharded_epnp_ransac.
    H must be a multiple of the mesh size."""
    from airdos_tpu.solvers.sim3 import Sim3RansacResult, horn_align

    def run(x1, x2, valid, sample_idx, max_err1, max_err2, fx, fy, cx, cy):
        def shard_fn(x1, x2, valid, samples_s, max_err1, max_err2):
            def reproj_inliers(R, t, s):
                p1 = s * (x2 @ R.T) + t
                z1 = jnp.where(jnp.abs(p1[:, 2]) < 1e-9, 1e-9, p1[:, 2])
                u1 = fx * p1[:, 0] / z1 + cx
                v1 = fy * p1[:, 1] / z1 + cy
                z1o = jnp.where(jnp.abs(x1[:, 2]) < 1e-9, 1e-9, x1[:, 2])
                e1 = (u1 - (fx * x1[:, 0] / z1o + cx)) ** 2 + \
                     (v1 - (fy * x1[:, 1] / z1o + cy)) ** 2
                p2 = (1.0 / s) * ((x1 - t) @ R)
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
                return R, t, s, jnp.sum(inl)

            Rs, ts, ss, counts = jax.vmap(one_hyp)(samples_s)
            k = jnp.argmax(counts)
            c_all = jax.lax.all_gather(counts[k], axis)
            R_all = jax.lax.all_gather(Rs[k], axis)
            t_all = jax.lax.all_gather(ts[k], axis)
            s_all = jax.lax.all_gather(ss[k], axis)
            g = jnp.argmax(c_all)
            R_b, t_b, s_b = R_all[g], t_all[g], s_all[g]
            inl_b = reproj_inliers(R_b, t_b, s_b)
            w = inl_b.astype(x1.dtype)
            R_r, t_r, s_r = horn_align(x1, x2, weights=w + 1e-6,
                                       fix_scale=fix_scale)
            inl_r = reproj_inliers(R_r, t_r, s_r)
            better = jnp.sum(inl_r) >= jnp.sum(inl_b)
            R_f = jnp.where(better, R_r, R_b)
            t_f = jnp.where(better, t_r, t_b)
            s_f = jnp.where(better, s_r, s_b)
            inl_f = jnp.where(better, inl_r, inl_b)
            return Sim3RansacResult(R=R_f, t=t_f, s=s_f, inliers=inl_f,
                                    n_inliers=jnp.sum(inl_f))

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(axis), P(), P()),
            out_specs=Sim3RansacResult(R=P(), t=P(), s=P(), inliers=P(),
                                       n_inliers=P()),
            check_vma=False)(x1, x2, valid, sample_idx, max_err1, max_err2)

    return jax.jit(run)


def sharded_human_bundle_adjust(mesh: Mesh, axis: str = "edges",
                                iters1: int = 5, iters2: int = 10):
    """The dynamic human-trajectory BA (solvers/human_ba.py — reference
    Optimizer::LocalBundleAdjustmentHumanTrajactory, Optimizer.cc:1496-2224)
    with the STATIC edge table sharded over the mesh: each device assembles
    the Schur blocks for its static-edge shard, the block aggregates are
    psum-reduced over the mesh, and the dense human system (joints + limb
    lengths + motions + cameras — tiny next to the static window) solves
    replicated.  Static edge arrays must be padded to a multiple of the
    mesh size (invalid rows es_valid=False).  Agreement with the
    single-chip solver is tested in tests/test_sharded_ba.py."""
    from airdos_tpu.solvers.human_ba import HumanBAResult, human_bundle_adjust

    def run(cam_R, cam_t, cam_fixed, points, point_valid,
            es_cam, es_pt, es_obs, es_info, es_valid,
            joints, joint_exists, jo_cam, jo_obs, jo_valid,
            seg_len, seg_free, seg_edge_valid,
            mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid,
            sigma_static, sigma_human, sigma_rigidity, sigma_motion,
            th_huber_motion, th_ransac_motion, th_ransac_rigidity,
            fx, fy, cx, cy, bf, use_huber=True):
        def shard_fn(cam_R, cam_t, cam_fixed, points, point_valid,
                     es_cam_s, es_pt_s, es_obs_s, es_info_s, es_valid_s,
                     joints, joint_exists, jo_cam, jo_obs, jo_valid,
                     seg_len, seg_free, seg_edge_valid,
                     mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid):
            return human_bundle_adjust(
                cam_R, cam_t, cam_fixed, points, point_valid,
                es_cam_s, es_pt_s, es_obs_s, es_info_s, es_valid_s,
                joints, joint_exists, jo_cam, jo_obs, jo_valid,
                seg_len, seg_free, seg_edge_valid,
                mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid,
                sigma_static, sigma_human, sigma_rigidity, sigma_motion,
                th_huber_motion, th_ransac_motion, th_ransac_rigidity,
                fx, fy, cx, cy, bf, use_huber=use_huber,
                iters1=iters1, iters2=iters2, axis_name=axis)

        rep = [P()] * 5 + [P(axis)] * 5 + [P()] * 13
        out_specs = HumanBAResult(
            cam_R=P(), cam_t=P(), points=P(), joints=P(), seg_len=P(),
            mot_R=P(), mot_t=P(), static_inlier=P(axis),
            key_inlier=P(), rigid_inlier=P(), motion_inlier=P())
        return jax.shard_map(
            shard_fn, mesh=mesh, in_specs=tuple(rep),
            out_specs=out_specs,
        )(cam_R, cam_t, cam_fixed, points, point_valid,
          es_cam, es_pt, es_obs, es_info, es_valid,
          joints, joint_exists, jo_cam, jo_obs, jo_valid,
          seg_len, seg_free, seg_edge_valid,
          mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid)

    return jax.jit(run, static_argnames=())


def sharded_global_bundle_adjust(mesh: Mesh, axis: str = "edges",
                                 iters1: int = 6, iters2: int = 10,
                                 cg_iters: int = 48):
    """Map-scale global BA (matrix-free Schur + PCG,
    solvers/global_ba.py) with the edge table sharded over the mesh: the
    O(E) gather/scatter contractions run on shard-local edges, every
    C/P-table reduction and CG dot product is psum-reduced over the mesh, and
    the replicated CG state stays tiny.  Edge arrays must be padded to a
    multiple of the mesh size."""
    from airdos_tpu.solvers.global_ba import (GlobalBAResult,
                                              global_bundle_adjust)

    def run(cam_R, cam_t, cam_fixed, points, point_valid,
            e_cam, e_pt, e_obs, e_info, e_valid, fx, fy, cx, cy, bf):
        def shard_fn(cam_R, cam_t, cam_fixed, points, point_valid,
                     e_cam_s, e_pt_s, e_obs_s, e_info_s, e_valid_s):
            return global_bundle_adjust(
                cam_R, cam_t, cam_fixed, points, point_valid,
                e_cam_s, e_pt_s, e_obs_s, e_info_s, e_valid_s,
                fx, fy, cx, cy, bf,
                iters1=iters1, iters2=iters2, cg_iters=cg_iters,
                axis_name=axis)

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(),
                      P(axis), P(axis), P(axis), P(axis), P(axis)),
            out_specs=GlobalBAResult(R=P(), t=P(), points=P(),
                                     edge_inlier=P(axis)),
        )(cam_R, cam_t, cam_fixed, points, point_valid,
          e_cam, e_pt, e_obs, e_info, e_valid)

    return jax.jit(run)
