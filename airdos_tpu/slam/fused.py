"""Fused per-frame device programs.

Each tracking stage (projection matching -> association gather -> pose-only
LM) is one jit program, so a tracked frame costs a few device dispatches
instead of dozens, and XLA can fuse across the stages.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.matching.projection import match_last_frame, match_local_points
from airdos_tpu.solvers.pose_opt import pose_optimize


class TrackStepResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    point_of_feat: jnp.ndarray   # [N] source index (-1 none); post-opt inliers only
    n_matches: jnp.ndarray       # matches before optimization
    n_real_inliers: jnp.ndarray  # inliers to real map points


def motion_model_step(xw_p, desc_p, oct_p, ang_p, valid_p, real_p,
                      R0, t0,
                      feat_xy_un, feat_ur, feat_oct, feat_ang, feat_desc,
                      feat_valid, inv_sigma2_feat,
                      fx, fy, cx, cy, bf, width, height,
                      scale_factors, th, forward, backward,
                      prior_w_rot=0.0, prior_w_trans=0.0) -> TrackStepResult:
    """SearchByProjection(cur, last, th) + PoseOptimization, fused."""
    taken = jnp.zeros(feat_xy_un.shape[0], bool)
    m = match_last_frame(xw_p, desc_p, oct_p, ang_p, valid_p,
                         R0, t0, feat_xy_un, feat_ur, feat_oct, feat_ang,
                         feat_desc, feat_valid, taken,
                         fx, fy, cx, cy, bf, width, height,
                         scale_factors, th, forward, backward)
    pof = m.point_of_feat
    has = pof >= 0
    src = jnp.maximum(pof, 0)
    xw = xw_p[src]
    obs = jnp.concatenate([feat_xy_un, feat_ur[:, None]], axis=1)
    res = pose_optimize(R0, t0, xw, obs, inv_sigma2_feat, has,
                        fx, fy, cx, cy, bf,
                        prior_w_rot=prior_w_rot, prior_w_trans=prior_w_trans)
    inl = res.inlier & has
    n_real = jnp.sum(inl & real_p[src]).astype(jnp.int32)
    return TrackStepResult(R=res.R, t=res.t,
                           point_of_feat=jnp.where(inl, pof, -1),
                           n_matches=m.n_matches, n_real_inliers=n_real)


def local_map_step(xw_c, desc_c, valid_c, normal_c, maxd_c, mind_c,
                   exist_xw, exist_valid, exist_real,
                   R0, t0, ow,
                   feat_xy_un, feat_ur, feat_oct, feat_desc, feat_valid,
                   inv_sigma2_feat,
                   fx, fy, cx, cy, bf, width, height,
                   scale_factors, log_scale, n_levels, th,
                   prior_w_rot=0.0, prior_w_trans=0.0) -> TrackStepResult:
    """SearchLocalPoints + PoseOptimization (TrackLocalMap), fused.

    exist_xw/exist_valid: the frame's current associations (by feature).
    Returns point_of_feat for NEW candidate matches only; inliers of
    existing associations are reported via n_real_inliers and the caller
    re-checks with the returned pose."""
    m = match_local_points(xw_c, desc_c, valid_c, normal_c, maxd_c, mind_c,
                           R0, t0, ow,
                           feat_xy_un, feat_ur, feat_oct, feat_desc,
                           feat_valid, exist_valid,
                           fx, fy, cx, cy, bf, width, height,
                           scale_factors, log_scale, n_levels, th)
    pof = m.point_of_feat
    cand_has = pof >= 0
    src = jnp.maximum(pof, 0)
    xw = jnp.where(exist_valid[:, None], exist_xw, xw_c[src])
    valid = exist_valid | cand_has
    obs = jnp.concatenate([feat_xy_un, feat_ur[:, None]], axis=1)
    res = pose_optimize(R0, t0, xw, obs, inv_sigma2_feat, valid,
                        fx, fy, cx, cy, bf,
                        prior_w_rot=prior_w_rot, prior_w_trans=prior_w_trans)
    inl = res.inlier & valid
    is_real = jnp.where(exist_valid, exist_real, cand_has)
    n_real = jnp.sum(inl & is_real).astype(jnp.int32)
    # inlier mask for existing associations is folded into point_of_feat:
    # -2 marks "existing association is an outlier, drop it"
    pof_out = jnp.where(cand_has & inl, pof,
                        jnp.where(exist_valid & ~inl, -2, -1))
    return TrackStepResult(R=res.R, t=res.t, point_of_feat=pof_out,
                           n_matches=m.n_matches, n_real_inliers=n_real)


class FullTrackResult(NamedTuple):
    """Transfer-packed: 4-5 device->host leaves in total, one host copy
    each."""
    feat_f32: jnp.ndarray   # [N, 8]: xy(2) xy_un(2) response angle u_right depth
    feat_i32: jnp.ndarray   # [N, 4]: octave valid motion_pof local_pof
    desc32: jnp.ndarray     # [N, 8] uint32
    scalars: jnp.ndarray    # [17]: R(9) t(3) n_motion n_inliers pad(3)
    disparity: jnp.ndarray  # [MAX_HUMANS * N_TORSO] joint disparity or [1]


def make_full_track_step(frontend, config):
    """Build the one-dispatch-per-frame tracking program.

    Fuses: pyramid/FAST/rBRIEF/stereo front-end -> motion-model projection
    match (with the reference's x2-window retry as a lax.cond) -> pose LM ->
    local-map projection match -> pose LM.  Only the final padded result
    arrays ever leave the device.
    """
    cam = config.camera
    fx, fy, cx, cy, bf = cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
    width, height = cam.width, cam.height
    orb = config.orb
    import numpy as _np
    scale_factors = jnp.asarray(
        [orb.scale_factor ** l for l in range(orb.n_levels)], jnp.float32)
    inv_sigma2 = 1.0 / (scale_factors ** 2)
    log_scale = float(_np.log(orb.scale_factor))
    n_levels = orb.n_levels
    opt = config.optimizer
    pw_rot = 1.0 / opt.motion_prior_sigma_rot ** 2 \
        if opt.motion_prior_sigma_rot > 0 else 0.0
    pw_trans = 1.0 / opt.motion_prior_sigma_t ** 2 \
        if opt.motion_prior_sigma_t > 0 else 0.0

    def step(imL_u8, imR_u8, maskL_u8, maskR_u8,
             torso_px,                # [MAX_HUMANS * N_TORSO, 2]
             prior_pack,              # [12]: R(9) t(3)
             last_f32,                # [Np, 8]: xw(3) ang oct valid real pad
             desc_p,
             cand_f32,                # [Pc, 9]: xw(3) normal(3) maxd mind valid
             desc_c,
             forward, backward, with_disparity):
        imL = imL_u8.astype(jnp.float32)
        imR = imR_u8.astype(jnp.float32)
        maskL = maskL_u8.astype(jnp.float32)
        maskR = maskR_u8.astype(jnp.float32)
        R_prior = prior_pack[:9].reshape(3, 3)
        t_prior = prior_pack[9:12]
        xw_p = last_f32[:, 0:3]
        ang_p = last_f32[:, 3]
        oct_p = last_f32[:, 4].astype(jnp.int32)
        valid_p = last_f32[:, 5] > 0
        real_p = last_f32[:, 6] > 0
        xw_c = cand_f32[:, 0:3]
        normal_c = cand_f32[:, 3:6]
        maxd_c = cand_f32[:, 6]
        mind_c = cand_f32[:, 7]
        valid_c = cand_f32[:, 8] > 0

        fL, fR, sm, xy_un, disp = frontend._build_impl(
            imL, imR, maskL, maskR, torso_px, with_disparity=with_disparity)
        isig = inv_sigma2[fL.octave]

        def motion(th):
            return motion_model_step(
                xw_p, desc_p, oct_p, ang_p, valid_p, real_p,
                R_prior, t_prior,
                xy_un, sm.u_right, fL.octave, fL.angle, fL.desc32, fL.valid,
                isig, fx, fy, cx, cy, bf, width, height,
                scale_factors, th, forward, backward,
                prior_w_rot=pw_rot, prior_w_trans=pw_trans)

        m7 = motion(7.0)
        m = jax.lax.cond(m7.n_matches < 20, lambda: motion(14.0), lambda: m7)

        # existing associations for the local stage = motion inlier matches
        src = jnp.maximum(m.point_of_feat, 0)
        exist_valid = m.point_of_feat >= 0
        exist_xw = xw_p[src]
        exist_real = real_p[src] & exist_valid

        loc = local_map_step(
            xw_c, desc_c, valid_c, normal_c, maxd_c, mind_c,
            exist_xw, exist_valid, exist_real,
            m.R, m.t, -m.R.T @ m.t,
            xy_un, sm.u_right, fL.octave, fL.desc32, fL.valid, isig,
            fx, fy, cx, cy, bf, width, height,
            scale_factors, log_scale, n_levels, 1.0,
            prior_w_rot=pw_rot, prior_w_trans=pw_trans)

        feat_f32 = jnp.concatenate([
            fL.xy, xy_un, fL.response[:, None], fL.angle[:, None],
            sm.u_right[:, None], sm.depth[:, None]], axis=1)
        feat_i32 = jnp.stack([
            fL.octave, fL.valid.astype(jnp.int32),
            m.point_of_feat, loc.point_of_feat], axis=1)
        scalars = jnp.concatenate([
            loc.R.reshape(-1), loc.t,
            m.n_matches.astype(jnp.float32)[None],
            loc.n_real_inliers.astype(jnp.float32)[None],
            jnp.zeros(3, jnp.float32)])
        return FullTrackResult(feat_f32=feat_f32, feat_i32=feat_i32,
                               desc32=fL.desc32, scalars=scalars,
                               disparity=disp)

    return jax.jit(step, static_argnames=("with_disparity",))
