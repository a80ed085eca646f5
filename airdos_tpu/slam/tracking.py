"""Tracking: the per-frame state machine.

Rebuild of the reference's Tracking (src/Tracking.cc) in its offline
(paper) configuration: init -> (motion-model | reference-KF) tracking ->
track-local-map -> keyframe decision -> map-point creation -> human-pose
grabbing, with the local-mapping steps run synchronously per frame
(Tracking::OffLineTrack, src/Tracking.cc:544-743).

Host Python owns the state machine and integer bookkeeping; every dense
step (projection matching, pose LM) is a jit-compiled device kernel with
static padded shapes.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from airdos_tpu.config import SlamConfig
from airdos_tpu.matching.projection import match_last_frame, match_local_points
from airdos_tpu.slam.frame import Frame, FrontEnd
from airdos_tpu.slam.map import HumanPose, KeyFrame, SlamMap
from airdos_tpu.solvers.pose_opt import pose_optimize


def _round_up_int(n: int, m: int) -> int:
    return -(-n // m) * m


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class FrameRecord:
    """Per-frame trajectory bookkeeping (reference: mlRelativeFramePoses)."""
    __slots__ = ("Tcr_R", "Tcr_t", "ref_kf_id", "timestamp", "lost")

    def __init__(self, Tcr_R, Tcr_t, ref_kf_id, timestamp, lost):
        self.Tcr_R = Tcr_R
        self.Tcr_t = Tcr_t
        self.ref_kf_id = ref_kf_id
        self.timestamp = timestamp
        self.lost = lost


class Tracking:
    def __init__(self, config: SlamConfig, frontend: FrontEnd, slam_map: SlamMap,
                 local_mapper=None):
        self.config = config
        self.frontend = frontend
        self.map = slam_map
        self.local_mapper = local_mapper
        self.state = TrackState.NO_IMAGES_YET

        cam = config.camera
        self.fx, self.fy = cam.fx, cam.fy
        self.cx, self.cy = cam.cx, cam.cy
        self.bf = cam.bf
        self.baseline = cam.baseline
        self.width, self.height = cam.width, cam.height
        self.th_depth = config.th_depth_m
        self.min_frames = 0
        self.max_frames = max(1, int(round(cam.fps)))
        # online mode wires these to the mapping worker's queue state
        # (reference LocalMapping::AcceptKeyFrames / KeyframesInQueue);
        # None = synchronous offline pipeline, always idle
        self.mapping_idle_fn = None
        self.mapping_queue_len_fn = None

        orb = config.orb
        self.scale_factors = np.asarray(
            [orb.scale_factor ** l for l in range(orb.n_levels)], np.float32)
        self.inv_sigma2 = (1.0 / (self.scale_factors ** 2)).astype(np.float32)
        self.log_scale = float(np.log(orb.scale_factor))
        self.n_levels = orb.n_levels
        opt = config.optimizer
        self.prior_w_rot = 1.0 / opt.motion_prior_sigma_rot ** 2 \
            if opt.motion_prior_sigma_rot > 0 else 0.0
        self.prior_w_trans = 1.0 / opt.motion_prior_sigma_t ** 2 \
            if opt.motion_prior_sigma_t > 0 else 0.0

        import threading
        self.map_lock = threading.Lock()  # tracking <-> mapping-thread guard
        # online: System installs a TrackingGate held across the per-frame
        # pack -> fused-step window so mapping-side workers defer their
        # dispatches while tracking needs the chip (utils/gate.py)
        self.device_gate = None
        self.profiler = None             # set by System (fine-grained spans)
        self.keyframe_db = None          # set by System once the vocab exists
        self._full_step = None           # lazily-built fused tracking program
        self._last_step_args = None      # last dispatch args (for MFU calc)
        self._sharded_pnp = None         # lazily-built multi-chip RANSAC
        self._ones_mask_dev = jnp.ones((self.height, self.width), jnp.uint8)
        self.last_frame: Optional[Frame] = None
        self.current: Optional[Frame] = None
        # localization-only mode: track against the frozen map, never
        # insert keyframes (reference System::ActivateLocalizationMode,
        # System.cc:288-296; Tracking mbOnlyTracking)
        self.only_tracking = False
        self.velocity: Optional[tuple] = None       # (R, t) of Tcl (cur<-last)
        self.last_branch = "none"                   # which track path ran
        self.last_kf_id = -1
        self.last_reloc_frame = -1e9
        self.records: List[FrameRecord] = []
        self.n_inliers = 0
        # temp VO points attached to the last frame: feat_idx -> world pos
        self._vo_points: Dict[int, np.ndarray] = {}

        from airdos_tpu.matching.bow_match import match_by_bow
        from airdos_tpu.slam.fused import local_map_step, motion_model_step
        self._jit_motion_step = jax.jit(motion_model_step,
                                        static_argnames=())
        self._jit_local_step = jax.jit(local_map_step,
                                       static_argnames=("n_levels",))
        self._jit_pose_opt = jax.jit(pose_optimize)
        self._jit_bow_match = jax.jit(match_by_bow,
                                      static_argnames=("check_rotation",))
        self._jit_reloc_match = jax.jit(match_last_frame)
        self._scale_factors_dev = jnp.asarray(self.scale_factors)

        self.max_local_points = config.device.max_local_points

    # ================================================================ api
    def track(self, data) -> Frame:
        """Process one stereo frame (GrabImageStereo[Human] + OffLineTrack)."""
        frame = None
        fast_ok = None
        self._reanchor_last_frame()
        # the motion model is unusable right after relocalization (velocity
        # spans a lost/garbage pose) — force reference-KF tracking for two
        # frames (reference Tracking.cc:587: mnId < mnLastRelocFrameId+2)
        just_relocalized = data.index < self.last_reloc_frame + 2
        if self.state == TrackState.OK and self.velocity is not None \
                and not just_relocalized:
            frame, fast_ok = self._track_fast(data)
        if frame is None:
            frame = self.frontend.build_frame(data)
        self.current = frame

        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self.state = TrackState.NOT_INITIALIZED
            self._stereo_initialization(frame)
            self.last_branch = "init"
        else:
            if fast_ok is not None:
                ok = fast_ok
                self.last_branch = "fast"
                if not ok:
                    frame.mp_idx[:] = -1
                    ok = self._track_reference_keyframe(frame)
                    self.last_branch = "fast->ref"
                    if ok:
                        ok = self._track_local_map(frame)
            else:
                ok = False
                if self.state == TrackState.OK:
                    if self.velocity is not None and not just_relocalized:
                        ok = self._track_with_motion_model(frame)
                        self.last_branch = "motion"
                    if not ok:
                        ok = self._track_reference_keyframe(frame)
                        self.last_branch = "ref"
                else:
                    ok = self._relocalization(frame)
                    self.last_branch = "reloc"
                if ok:
                    ok = self._track_local_map(frame)
            if ok:
                self.state = TrackState.OK
                self._update_velocity(frame)
                self._clean_vo_matches(frame)
                from airdos_tpu.utils.obs import span as _span
                with _span(self.profiler, "track.kf"), self.map_lock:
                    if not self.only_tracking and self._need_new_keyframe(frame):
                        self._create_new_keyframe(frame)
                    elif self.config.human.ok and frame.humans and \
                            not self.only_tracking and \
                            not self.config.optimizer.is_keyframe_only:
                        # IsKeyFrameOnly=0: human poses enter on EVERY
                        # tracked frame (reference Tracking.cc:493)
                        self._grab_human_poses(frame, kf=None)
                # mark outliers as free slots (reference: Track() end)
                frame.mp_idx[frame.outlier] = -1
            else:
                self.state = TrackState.LOST
                if self.map.n_keyframes() <= 5:
                    # lost right after init -> reset (reference Tracking.cc:508)
                    self._reset()

        self._record_frame(frame)
        frame.lost = self.state != TrackState.OK
        # store Tlr (pose relative to the reference KF) so the next step can
        # re-anchor this frame after BA / loop corrections move KF poses
        # (reference Tracking::UpdateLastFrame, Tracking.cc:877)
        ref = self.map.kfs.get(frame.ref_kf_id) \
            if frame.ref_kf_id is not None else None
        if ref is not None and not frame.lost:
            frame.Tlr = ((frame.Rcw @ ref.Rwc).astype(np.float32),
                         (frame.Rcw @ ref.Ow + frame.tcw).astype(np.float32))
        else:
            frame.Tlr = None
        self.last_frame = frame
        return frame

    def _reanchor_last_frame(self):
        """Re-express the last frame's pose through its reference keyframe:
        Tlw = Tlr * Trw.  Keeps the motion-model prediction consistent when
        local BA or a loop closure has moved KF poses since the frame was
        tracked (reference Tracking::UpdateLastFrame, Tracking.cc:877)."""
        lf = self.last_frame
        if lf is None or getattr(lf, "Tlr", None) is None:
            return
        ref = self.map.kfs.get(lf.ref_kf_id)
        if ref is None:
            return
        Rlr, tlr = lf.Tlr
        lf.set_pose(Rlr @ ref.Rcw, Rlr @ ref.tcw + tlr)

    # ======================================================== init / reset
    def _stereo_initialization(self, frame: Frame):
        n_valid = int(frame.valid.sum())
        if n_valid < 500:
            return
        frame.set_pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        kf = KeyFrame(self.map.next_kf_id, frame)
        self.map.next_kf_id += 1
        self.map.add_keyframe(kf)

        good = np.nonzero((frame.depth > 0) & frame.valid)[0]
        if len(good) < 50:
            self.map.kfs.pop(kf.id)
            return
        pos = frame.unproject_features(good)
        pids = self.map.create_points(kf, good, pos)
        frame.mp_idx[good] = pids
        frame.ref_kf_id = kf.id
        self.last_kf_id = kf.id
        if self.local_mapper is not None:
            self.local_mapper.recent_points.extend(pids.tolist())
        if self.config.human.ok and frame.humans:
            self._grab_human_poses(frame, kf=kf)
        self.state = TrackState.OK

    def _reset(self):
        self.map.__init__()
        self.state = TrackState.NOT_INITIALIZED
        self.velocity = None
        self.last_kf_id = -1
        self._vo_points = {}
        self.records = []
        if self.local_mapper is not None:
            self.local_mapper.recent_points = []

    # ==================================================== fast fused path
    def _candidate_arrays(self, ref_frame: Frame):
        """Local-map candidate tables based on a frame's associations."""
        pt = self.map.points
        saved_ref = ref_frame.ref_kf_id
        local_kfs = self._local_keyframes(ref_frame)
        ref_frame.ref_kf_id = saved_ref
        matched = set(int(p) for p in ref_frame.mp_idx[ref_frame.mp_idx >= 0])
        cand, seen = [], set()
        for kf_id in local_kfs:
            kf = self.map.kfs.get(kf_id)
            if kf is None:
                continue
            for pid in kf.mp_idx[kf.mp_idx >= 0]:
                p = int(pid)
                if p in seen or p in matched or pt.bad[p]:
                    continue
                seen.add(p)
                cand.append(p)
        cand = cand[-self.max_local_points:] \
            if len(cand) > self.max_local_points else cand
        n_c = len(cand)
        P = self.max_local_points   # fixed: exactly one jit variant
        ids = np.asarray(cand, np.int64) if n_c else np.zeros(0, np.int64)
        xw = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        valid = np.zeros(P, bool)
        if n_c:
            xw[:n_c] = pt.pos[ids]
            desc[:n_c] = pt.desc32[ids]
            normal[:n_c] = pt.normal[ids]
            mind[:n_c] = pt.min_dist[ids]
            maxd[:n_c] = pt.max_dist[ids]
            valid[:n_c] = True
        return ids, xw, desc, valid, normal, maxd, mind

    def fused_cost_analysis(self):
        """XLA cost analysis of the compiled fused tracking step (flops /
        bytes accessed), from the last dispatch's argument shapes.  Lowering
        hits the jit cache, so this is cheap after the first frame; used by
        bench.py to report an MFU estimate alongside the stage timings."""
        if self._full_step is None or self._last_step_args is None:
            return None
        step_args, want_disp = self._last_step_args
        try:
            c = self._full_step.lower(
                *step_args, with_disparity=want_disp).compile().cost_analysis()
        except Exception:
            return None
        if isinstance(c, (list, tuple)):          # older jax: per-device list
            c = c[0] if c else None
        if not c:
            return None
        return {"flops": float(c.get("flops", 0.0)),
                "bytes_accessed": float(c.get("bytes accessed", 0.0))}

    def _track_fast(self, data):
        """One device dispatch for front-end + motion + local-map tracking."""
        lf = self.last_frame
        if lf is None:
            return None, None
        if self._full_step is None:
            from airdos_tpu.slam.fused import make_full_track_step
            self._full_step = make_full_track_step(self.frontend, self.config)

        from airdos_tpu.utils.obs import span
        with span(self.profiler, "track.prep"), self.map_lock:
            self._update_last_frame_vo_points()
            xw_p, valid_p = self._gather_last_frame_points(lf)
            if valid_p.sum() < 10:
                return None, None
            pt = self.map.points
            desc_p = np.zeros((lf.n_slots, 8), np.uint32)
            real_p = np.zeros(lf.n_slots, bool)
            has_mp = lf.mp_idx >= 0
            mp_rows = np.nonzero(has_mp & valid_p)[0]
            desc_p[mp_rows] = pt.desc32[lf.mp_idx[mp_rows]]
            real_p[mp_rows] = True
            vo_rows = [i for i in self._vo_points if not has_mp[i]]
            if vo_rows:
                desc_p[vo_rows] = lf.desc32[vo_rows]

            ids, xw_c, desc_c, valid_c, normal_c, maxd_c, mind_c = \
                self._candidate_arrays(lf)

        import contextlib
        gate_cm = self.device_gate if self.device_gate is not None \
            else contextlib.nullcontext()
        # holding the gate across the pack and step windows keeps
        # mapping-side programs out of the device FIFO while tracking
        # needs the chip, so the fused step runs at standalone latency
        # (the pack->step handoff happens without yielding the GIL, so
        # a polling worker cannot slip a dispatch between the two)
        with gate_cm, span(self.profiler, "track.pack"):
            Rv, tv = self.velocity
            Rp = (Rv @ lf.Rcw).astype(np.float32)
            tp = (Rv @ lf.tcw + tv).astype(np.float32)
            ow_pred = -Rp.T @ tp
            t_lc = lf.Rcw @ (ow_pred - lf.Ow)
            forward = bool(t_lc[2] > self.baseline)
            backward = bool(-t_lc[2] > self.baseline)

            cfg = self.config
            # uint8 uploads (possibly prefetched): the device casts; f32
            # images cost ~4x on transfer
            imL, imR, maskL, maskR = self.frontend.uploads(data)
            if maskL is None:
                maskL = self._ones_mask_dev
                maskR = self._ones_mask_dev
            want_disp = bool(cfg.human.ok and data.humans_left is not None
                             and len(data.humans_left) > 0
                             and not (cfg.system.is_ground_truth_depth
                                      and data.depth is not None))
            from airdos_tpu.slam.frame import (MAX_HUMANS, N_TORSO,
                                               torso_pixels)
            torso_px = torso_pixels(data.humans_left) if want_disp else \
                np.full((MAX_HUMANS * N_TORSO, 2), -1.0, np.float32)

            prior_pack = np.concatenate([Rp.reshape(-1),
                                         tp]).astype(np.float32)
            Np = lf.n_slots
            last_f32 = np.zeros((Np, 8), np.float32)
            last_f32[:, 0:3] = xw_p
            last_f32[:, 3] = lf.angle
            last_f32[:, 4] = lf.octave
            last_f32[:, 5] = valid_p
            last_f32[:, 6] = real_p
            Pc = xw_c.shape[0]
            cand_f32 = np.zeros((Pc, 9), np.float32)
            cand_f32[:, 0:3] = xw_c
            cand_f32[:, 3:6] = normal_c
            cand_f32[:, 6] = maxd_c
            cand_f32[:, 7] = mind_c
            cand_f32[:, 8] = valid_c

        with gate_cm, span(self.profiler, "track.step"):
            step_args = (imL, imR, maskL, maskR,
                         jnp.asarray(torso_px),
                         jnp.asarray(prior_pack),
                         jnp.asarray(last_f32), jnp.asarray(desc_p),
                         jnp.asarray(cand_f32), jnp.asarray(desc_c),
                         forward, backward)
            res = self._full_step(*step_args, with_disparity=want_disp)
            host = jax.device_get(res)
        # keep references (not copies) for fused_cost_analysis()
        self._last_step_args = (step_args, want_disp)
        frame = Frame.from_track_result(self.frontend, data, host)
        sc = host.scalars
        frame.set_pose(sc[:9].reshape(3, 3), sc[9:12])

        n_motion = int(sc[12])
        n_inliers = int(sc[13])
        if n_motion < 20:
            return frame, False

        with span(self.profiler, "track.assoc"), self.map_lock:
            # associations: motion matches (last-frame slots -> pids/VO)
            mp_idx = frame.mp_idx
            mpof = host.feat_i32[:, 2]
            for fid in np.nonzero(mpof >= 0)[0]:
                src = mpof[fid]
                pid = lf.mp_idx[src]
                if pid >= 0 and not pt.bad[pid]:
                    mp_idx[fid] = pid
                elif src in self._vo_points:
                    mp_idx[fid] = -2 - src
            # local candidate matches
            lpof = host.feat_i32[:, 3]
            new_rows = np.nonzero(lpof >= 0)[0]
            if len(new_rows) and len(ids):
                mp_idx[new_rows] = ids[lpof[new_rows]]
            drop = np.nonzero(lpof == -2)[0]
            frame.outlier = np.zeros(frame.n_slots, bool)
            frame.outlier[drop] = True
            mp_idx[drop] = -1

            if len(ids):
                pt.visible[ids] += 1
            found_rows = np.nonzero(mp_idx >= 0)[0]
            if len(found_rows):
                pt.found[mp_idx[found_rows]] += 1
            self.n_inliers = n_inliers
            self._local_keyframes(frame)     # sets frame.ref_kf_id
            ok = n_inliers >= 30 or (self.map.n_keyframes() <= 2
                                     and n_inliers >= 15)
        return frame, ok

    # ==================================================== frame-to-frame
    def _gather_last_frame_points(self, frame_last: Frame):
        """Arrays over last-frame feature slots: world pos + validity, using
        live map points (current optimized positions) and temp VO points."""
        n = frame_last.n_slots
        xw = np.zeros((n, 3), np.float32)
        valid = np.zeros(n, bool)
        pt = self.map.points
        has_mp = frame_last.mp_idx >= 0
        ids = np.nonzero(has_mp)[0]
        if len(ids):
            pids = frame_last.mp_idx[ids]
            live = ~pt.bad[pids]
            xw[ids[live]] = pt.pos[pids[live]]
            valid[ids[live]] = True
        for fid, pos in self._vo_points.items():
            if not valid[fid]:
                xw[fid] = pos
                valid[fid] = True
        return xw, valid

    def _update_last_frame_vo_points(self):
        """Create temporary close-depth points for the last frame (reference
        Tracking::UpdateLastFrame 'visual odometry' points).

        CRITICAL parity detail: the reference creates these ONLY in
        localization-only mode (Tracking.cc: '!mbOnlyTracking -> return').
        In mapping mode every association must be a real, BA-corrected map
        point — temporal points are anchored to the last frame's own
        estimated pose, so matching against them feeds pose drift back
        into itself and the error compounds geometrically."""
        self._vo_points = {}
        lf = self.last_frame
        if not self.only_tracking:
            return
        if lf is None or lf.ref_kf_id is None:
            return
        if lf.index == self._kf_frame_index():
            return      # last frame became a keyframe: its points are real
        depths = lf.depth
        cand = np.nonzero((depths > 0) & lf.valid & (lf.mp_idx < 0))[0]
        if len(cand) == 0:
            return
        order = cand[np.argsort(depths[cand])]
        n_close = 0
        for fid in order:
            if depths[fid] > self.th_depth and n_close >= 100:
                break
            self._vo_points[int(fid)] = lf.unproject_feature(int(fid))
            n_close += 1

    def _track_with_motion_model(self, frame: Frame) -> bool:
        self._update_last_frame_vo_points()
        lf = self.last_frame
        Rv, tv = self.velocity
        Rp = Rv @ lf.Rcw
        tp = Rv @ lf.tcw + tv
        frame.set_pose(Rp, tp)

        xw, valid_p = self._gather_last_frame_points(lf)
        if valid_p.sum() < 10:
            return False

        # forward/backward along optical axis (reference: tlc.z > b)
        t_lc = lf.Rcw @ (frame.Ow - lf.Ow)
        forward = bool(t_lc[2] > self.baseline)
        backward = bool(-t_lc[2] > self.baseline)

        pt = self.map.points
        desc_p = np.zeros((lf.n_slots, 8), np.uint32)
        real_p = np.zeros(lf.n_slots, bool)
        has_mp = lf.mp_idx >= 0
        mp_rows = np.nonzero(has_mp & valid_p)[0]
        desc_p[mp_rows] = pt.desc32[lf.mp_idx[mp_rows]]
        real_p[mp_rows] = True
        vo_rows = [i for i in self._vo_points if not has_mp[i]]
        if vo_rows:
            desc_p[vo_rows] = lf.desc32[vo_rows]

        n, res = self._run_motion_step(frame, lf, xw, desc_p, real_p, valid_p,
                                       7.0, forward, backward)
        if n < 20:
            n, res = self._run_motion_step(frame, lf, xw, desc_p, real_p,
                                           valid_p, 14.0, forward, backward)
        if n < 20:
            return False
        R, t, pof, n_real = res
        frame.set_pose(R, t)
        feat_ids = np.nonzero(pof >= 0)[0]
        for fid in feat_ids:
            src = pof[fid]
            pid = lf.mp_idx[src]
            if pid >= 0 and not pt.bad[pid]:
                frame.mp_idx[fid] = pid
            elif src in self._vo_points:
                frame.mp_idx[fid] = -2 - src    # temp VO association
        return n_real >= 10

    def _run_motion_step(self, frame, src_frame, xw, desc_p, real_p, valid_p,
                         th, forward, backward):
        out = self._jit_motion_step(
            jnp.asarray(xw), jnp.asarray(desc_p),
            jnp.asarray(src_frame.octave), jnp.asarray(src_frame.angle),
            jnp.asarray(valid_p), jnp.asarray(real_p),
            jnp.asarray(frame.Rcw), jnp.asarray(frame.tcw),
            frame.dev["xy_un"], frame.dev["u_right"], frame.dev["octave"],
            frame.dev["angle"], frame.dev["desc32"], frame.dev["valid"],
            jnp.asarray(self.inv_sigma2[frame.octave]),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            self._scale_factors_dev, th, forward, backward,
            self.prior_w_rot, self.prior_w_trans)
        R, t, pof, n_matches, n_real = jax.device_get(
            (out.R, out.t, out.point_of_feat, out.n_matches,
             out.n_real_inliers))
        return int(n_matches), (R, t, pof, int(n_real))

    def _decode_vo(self, code: int) -> int:
        return -2 - code

    # =================================================== reference-KF track
    def _frame_nodes(self, frame: Frame) -> np.ndarray:
        """Per-feature vocabulary node ids at the grouping level (lazily
        computed and cached on the frame; Frame::ComputeBoW semantics)."""
        nodes = getattr(frame, "feat_nodes", None)
        if nodes is None:
            _, _, nodes = self.keyframe_db.voc.transform(frame.desc32,
                                                         frame.valid)
            frame.feat_nodes = nodes
        return nodes

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """SearchByBoW against the reference KF + motion-only pose opt
        (reference Tracking::TrackReferenceKeyFrame, Tracking.cc:827-869;
        ORBmatcher::SearchByBoW KF<->Frame, ORBmatcher.cc:159-288).  Falls
        back to a wide projection search when no vocabulary is loaded."""
        if frame.ref_kf_id is None:
            frame.ref_kf_id = self.last_kf_id
        kf = self.map.kfs.get(self.last_kf_id)
        if kf is None:
            return False
        if self.keyframe_db is not None:
            return self._track_ref_kf_bow(frame, kf)
        return self._track_ref_kf_projection(frame, kf)

    def _track_ref_kf_bow(self, frame: Frame, kf) -> bool:
        pt = self.map.points
        self.keyframe_db.ensure_bow(kf)
        fnodes = self._frame_nodes(frame)
        m = self._jit_bow_match(
            jnp.asarray(kf.desc32), jnp.asarray(kf.feat_nodes),
            jnp.asarray(kf.valid & (kf.mp_idx >= 0)), jnp.asarray(kf.angle),
            frame.dev["desc32"], jnp.asarray(fnodes),
            frame.dev["valid"], frame.dev["angle"])
        idx2 = np.asarray(m.idx2)
        n_matches = 0
        for f1 in np.nonzero(idx2 >= 0)[0]:
            pid = int(kf.mp_idx[f1])
            if pid >= 0 and not pt.bad[pid]:
                frame.mp_idx[int(idx2[f1])] = pid
                n_matches += 1
        if n_matches < 15:
            frame.mp_idx[:] = -1
            return False
        frame.set_pose(self.last_frame.Rcw, self.last_frame.tcw)
        n_real = self._opt_pose_with_assoc(frame)
        return n_real >= 10

    def _track_ref_kf_projection(self, frame: Frame, kf) -> bool:
        """No-vocabulary fallback: wide projection search from the reference
        KF's points (serves SearchByBoW's short-baseline recovery role)."""
        frame.set_pose(self.last_frame.Rcw, self.last_frame.tcw)
        xw = np.zeros((kf.n_slots, 3), np.float32)
        valid = np.zeros(kf.n_slots, bool)
        pt = self.map.points
        rows = np.nonzero(kf.mp_idx >= 0)[0]
        if len(rows) == 0:
            return False
        pids = kf.mp_idx[rows]
        live = ~pt.bad[pids]
        xw[rows[live]] = pt.pos[pids[live]]
        valid[rows[live]] = True

        desc_p = np.zeros((kf.n_slots, 8), np.uint32)
        desc_p[rows[live]] = pt.desc32[pids[live]]
        real_p = valid.copy()
        n, res = self._run_motion_step(frame, kf, xw, desc_p, real_p, valid,
                                       15.0, False, False)
        if n < 15:
            return False
        R, t, pof, n_real = res
        frame.set_pose(R, t)
        for fid in np.nonzero(pof >= 0)[0]:
            pid = kf.mp_idx[pof[fid]]
            if pid >= 0 and not pt.bad[pid]:
                frame.mp_idx[fid] = pid
        return n_real >= 10

    def _relocalization(self, frame: Frame) -> bool:
        """BoW candidate retrieval + EPnP-RANSAC + pose refinement
        (reference: Tracking::Relocalization, Tracking.cc:1493-1654),
        falling back to projection from the last pose when no database."""
        if self.keyframe_db is not None and self.map.kfs:
            if self._relocalize_bow(frame):
                self.last_reloc_frame = frame.index
                from airdos_tpu.utils.obs import get_logger
                get_logger().emit("relocalized", frame=frame.index,
                                  ref_kf=frame.ref_kf_id)
                return True
        if self.last_frame is None:
            return False
        return self._track_reference_keyframe(frame)

    def _relocalize_bow(self, frame: Frame) -> bool:
        """Reference protocol (Tracking::Relocalization, Tracking.cc:1493-
        1654): BoW candidates -> per-candidate SearchByBoW >=15 -> EPnP
        RANSAC -> pose opt -> projective match expansion at 10px/ORBdist 100
        if <50 inliers -> re-opt -> narrow 3px/ORBdist 64 expansion if still
        30..50 -> accept only with >=50 inliers."""
        from airdos_tpu.solvers.epnp import epnp_ransac
        # multi-device: hypothesis-parallel RANSAC over the device mesh
        # (identical protocol/result; SURVEY §2c scaling axis)
        if self.config.device.n_chips > 1 and self._sharded_pnp is None:
            from airdos_tpu.parallel.sharded_ba import (make_mesh,
                                                        sharded_epnp_ransac)
            self._sharded_pnp = sharded_epnp_ransac(
                make_mesh(self.config.device.n_chips))
        db = self.keyframe_db
        bow, wids, fnodes = db.voc.transform(frame.desc32, frame.valid)
        frame.feat_nodes = fnodes
        cands = db.detect_reloc_candidates(bow)
        pt = self.map.points
        rng = np.random.default_rng(frame.index)
        # try ALL candidates until one passes (the reference iterates its
        # whole vpCandidateKFs set, Tracking.cc:1516-1654)
        for kid in cands:
            kf = self.map.kfs.get(kid)
            if kf is None or kf.bad:
                continue
            db.ensure_bow(kf)
            m = self._jit_bow_match(
                jnp.asarray(kf.desc32), jnp.asarray(kf.feat_nodes),
                jnp.asarray(kf.valid), jnp.asarray(kf.angle),
                frame.dev["desc32"], jnp.asarray(fnodes),
                frame.dev["valid"], frame.dev["angle"])
            idx2 = np.asarray(m.idx2)
            rows = []
            for f1 in np.nonzero(idx2 >= 0)[0]:
                pid = int(kf.mp_idx[f1])
                if pid >= 0 and not pt.bad[pid]:
                    rows.append((pid, int(idx2[f1])))
            if len(rows) < 15:
                continue
            n = len(rows)
            pw = pt.pos[[r[0] for r in rows]].astype(np.float32)
            feat_ids = np.asarray([r[1] for r in rows])
            uv = frame.xy_un[feat_ids].astype(np.float32)
            max_err2 = (5.991 / self.inv_sigma2[frame.octave[feat_ids]]).astype(np.float32)
            n_hyp = self.config.device.ransac_hypotheses
            if self.config.device.n_chips > 1:
                n_hyp = _round_up_int(n_hyp, self.config.device.n_chips)
            samples = rng.integers(0, n, (n_hyp, 4)).astype(np.int32)
            pnp = self._sharded_pnp or epnp_ransac
            res = pnp(jnp.asarray(pw), jnp.asarray(uv),
                      jnp.ones(n, bool), jnp.asarray(max_err2),
                      jnp.asarray(samples),
                      self.fx, self.fy, self.cx, self.cy)
            n_inl, R, t, inl = jax.device_get(
                (res.n_inliers, res.R, res.t, res.inliers))
            if int(n_inl) < 10:
                continue
            frame.mp_idx[:] = -1
            frame.set_pose(R, t)
            for (pid, fid), keep in zip(rows, inl):
                if keep:
                    frame.mp_idx[fid] = pid
            n_good = self._opt_pose_with_assoc(frame)
            if n_good < 10:
                frame.mp_idx[:] = -1
                continue
            if n_good < 50:
                # first projective expansion: 10 px window, ORBdist 100
                added = self._reloc_expand(frame, kf, th=10.0, orb_dist=100)
                if n_good + added >= 50:
                    n_good = self._opt_pose_with_assoc(frame)
                    if 30 < n_good < 50:
                        # narrow second expansion: 3 px window, ORBdist 64
                        self._reloc_expand(frame, kf, th=3.0, orb_dist=64)
                        n_good = self._opt_pose_with_assoc(frame)
            if n_good >= 50:
                frame.ref_kf_id = kid
                return True
            frame.mp_idx[:] = -1
        return False

    def _reloc_expand(self, frame: Frame, kf, th: float, orb_dist: int) -> int:
        """Project the candidate KF's map points not yet matched into the
        frame and add matches within th px and Hamming <= orb_dist
        (ORBmatcher::SearchByProjection reloc variant, ORBmatcher.cc:
        1472-1599)."""
        pt = self.map.points
        already = set(int(p) for p in frame.mp_idx[frame.mp_idx >= 0])
        xw = np.zeros((kf.n_slots, 3), np.float32)
        valid = np.zeros(kf.n_slots, bool)
        desc_p = np.zeros((kf.n_slots, 8), np.uint32)
        rows = np.nonzero(kf.mp_idx >= 0)[0]
        for fid in rows:
            pid = int(kf.mp_idx[fid])
            if pid in already or pt.bad[pid]:
                continue
            xw[fid] = pt.pos[pid]
            desc_p[fid] = pt.desc32[pid]
            valid[fid] = True
        if not valid.any():
            return 0
        taken = frame.mp_idx >= 0
        out = self._jit_reloc_match(
            jnp.asarray(xw), jnp.asarray(desc_p),
            jnp.asarray(kf.octave), jnp.asarray(kf.angle),
            jnp.asarray(valid),
            jnp.asarray(frame.Rcw), jnp.asarray(frame.tcw),
            frame.dev["xy_un"], frame.dev["u_right"], frame.dev["octave"],
            frame.dev["angle"], frame.dev["desc32"],
            jnp.asarray(frame.valid), jnp.asarray(taken),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            self._scale_factors_dev, th, False, False)
        feat_idx, dist = jax.device_get((out.feat_idx, out.dist))
        added = 0
        for src in np.nonzero(feat_idx >= 0)[0]:
            if dist[src] > orb_dist:
                continue
            pid = int(kf.mp_idx[src])
            fid = int(feat_idx[src])
            if pid >= 0 and not pt.bad[pid] and frame.mp_idx[fid] < 0:
                frame.mp_idx[fid] = pid
                added += 1
        return added

    def _opt_pose_with_assoc(self, frame: Frame) -> int:
        pt = self.map.points
        n = frame.n_slots
        xw = np.zeros((n, 3), np.float32)
        valid = np.zeros(n, bool)
        rows = np.nonzero(frame.mp_idx >= 0)[0]
        if len(rows) < 6:
            return 0
        pids = frame.mp_idx[rows]
        live = ~pt.bad[pids]
        xw[rows[live]] = pt.pos[pids[live]]
        valid[rows[live]] = True
        obs = np.concatenate([frame.xy_un, frame.u_right[:, None]],
                             axis=1).astype(np.float32)
        res = self._jit_pose_opt(
            jnp.asarray(frame.Rcw), jnp.asarray(frame.tcw),
            jnp.asarray(xw), jnp.asarray(obs),
            jnp.asarray(self.inv_sigma2[frame.octave]), jnp.asarray(valid),
            self.fx, self.fy, self.cx, self.cy, self.bf)
        R, t, inlier = jax.device_get((res.R, res.t, res.inlier))
        frame.set_pose(R, t)
        frame.mp_idx[valid & ~inlier] = -1
        return int(inlier.sum())

    # ======================================================= local map
    def _local_keyframes(self, frame: Frame) -> List[int]:
        votes: Dict[int, int] = {}
        pt = self.map.points
        for fid in np.nonzero(frame.mp_idx >= 0)[0]:
            pid = frame.mp_idx[fid]
            if pid < 0 or pt.bad[pid]:
                continue
            for kf_id in pt.obs[pid]:
                votes[kf_id] = votes.get(kf_id, 0) + 1
        if not votes:
            return []
        local = sorted(votes, key=lambda k: -votes[k])
        best = local[0]
        out = list(local[:80])
        seen = set(out)
        for kf_id in list(out):
            kf = self.map.kfs.get(kf_id)
            if kf is None:
                continue
            for nb in kf.best_covisible(10):
                if nb not in seen and not self.map.kfs[nb].bad:
                    out.append(nb)
                    seen.add(nb)
                    break
            for ch in kf.children:
                if ch not in seen:
                    out.append(ch)
                    seen.add(ch)
                    break
            if kf.parent is not None and kf.parent not in seen:
                out.append(kf.parent)
                seen.add(kf.parent)
            if len(out) >= 80:
                break
        frame.ref_kf_id = best
        return out[:80]

    def _track_local_map(self, frame: Frame) -> bool:
        local_kfs = self._local_keyframes(frame)
        if not local_kfs:
            return False
        pt = self.map.points
        matched = set(int(p) for p in frame.mp_idx[frame.mp_idx >= 0])
        cand: List[int] = []
        seen = set()
        for kf_id in local_kfs:
            kf = self.map.kfs.get(kf_id)
            if kf is None:
                continue
            for pid in kf.mp_idx[kf.mp_idx >= 0]:
                p = int(pid)
                if p in seen or p in matched or pt.bad[p]:
                    continue
                seen.add(p)
                cand.append(p)
        P = self.max_local_points
        cand = cand[-P:] if len(cand) > P else cand
        n_c = len(cand)
        ids = np.asarray(cand, np.int64) if n_c else np.zeros(0, np.int64)
        xw = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        valid = np.zeros(P, bool)
        if n_c:
            xw[:n_c] = pt.pos[ids]
            desc[:n_c] = pt.desc32[ids]
            normal[:n_c] = pt.normal[ids]
            mind[:n_c] = pt.min_dist[ids]
            maxd[:n_c] = pt.max_dist[ids]
            valid[:n_c] = True

        # existing associations (map + VO) by feature slot
        n = frame.n_slots
        exist_xw = np.zeros((n, 3), np.float32)
        exist_valid = np.zeros(n, bool)
        exist_real = np.zeros(n, bool)
        mp_rows = np.nonzero(frame.mp_idx >= 0)[0]
        if len(mp_rows):
            pids = frame.mp_idx[mp_rows]
            live = ~pt.bad[pids]
            rows = mp_rows[live]
            exist_xw[rows] = pt.pos[pids[live]]
            exist_valid[rows] = True
            exist_real[rows] = True
        for fid in np.nonzero(frame.mp_idx <= -2)[0]:
            src = self._decode_vo(frame.mp_idx[fid])
            if src in self._vo_points:
                exist_xw[fid] = self._vo_points[src]
                exist_valid[fid] = True

        out = self._jit_local_step(
            jnp.asarray(xw), jnp.asarray(desc), jnp.asarray(valid),
            jnp.asarray(normal), jnp.asarray(maxd), jnp.asarray(mind),
            jnp.asarray(exist_xw), jnp.asarray(exist_valid),
            jnp.asarray(exist_real),
            jnp.asarray(frame.Rcw), jnp.asarray(frame.tcw),
            jnp.asarray(frame.Ow),
            frame.dev["xy_un"], frame.dev["u_right"], frame.dev["octave"],
            frame.dev["desc32"], frame.dev["valid"],
            jnp.asarray(self.inv_sigma2[frame.octave]),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            self._scale_factors_dev, self.log_scale, self.n_levels, 1.0,
            self.prior_w_rot, self.prior_w_trans)
        R, t, pof, n_real = jax.device_get(
            (out.R, out.t, out.point_of_feat, out.n_real_inliers))
        frame.set_pose(R, t)
        # new candidate matches
        new_rows = np.nonzero(pof >= 0)[0]
        if len(new_rows) and n_c:
            frame.mp_idx[new_rows] = ids[pof[new_rows]]
        # existing associations flagged outlier
        drop = np.nonzero(pof == -2)[0]
        frame.outlier = np.zeros(n, bool)
        frame.outlier[drop] = True
        frame.mp_idx[drop] = -1
        if n_c:
            pt.visible[ids] += 1

        n_inliers = int(n_real)
        inl = np.nonzero(frame.mp_idx >= 0)[0]
        if len(inl):
            pt.found[frame.mp_idx[inl]] += 1
        self.n_inliers = n_inliers
        return n_inliers >= 30 or (self.map.n_keyframes() <= 2 and n_inliers >= 15)

    # ======================================================= keyframing
    def _clean_vo_matches(self, frame: Frame):
        frame.mp_idx[frame.mp_idx <= -2] = -1

    def _tracked_close(self, frame: Frame):
        close = (frame.depth > 0) & (frame.depth < self.th_depth) & frame.valid
        tracked = close & (frame.mp_idx >= 0) & ~frame.outlier
        untracked = close & (frame.mp_idx < 0)
        return int(tracked.sum()), int(untracked.sum())

    def _need_new_keyframe(self, frame: Frame) -> bool:
        n_kfs = self.map.n_keyframes()
        ref = self.map.kfs.get(frame.ref_kf_id if frame.ref_kf_id is not None
                               else self.last_kf_id)
        if ref is None:
            return False
        min_obs = 3 if n_kfs > 2 else 2
        pt = self.map.points
        rows = ref.mp_idx[ref.mp_idx >= 0]
        ref_matches = int(((pt.n_obs[rows] >= min_obs) & ~pt.bad[rows]).sum()) \
            if len(rows) else 0
        n_close, n_unclose = self._tracked_close(frame)
        need_close = (n_close < 100) and (n_unclose > 70)
        # The reference drops thRefRatio to 0.4 while the map has <2 KFs
        # (Tracking.cc:1091) to avoid KF spam after the fragile MONO init.
        # Stereo init creates a complete point set at KF0, and with the
        # 0.4 ratio a scene whose close features leave the FOV before
        # inliers fall below 40% of the reference count inserts NO second
        # keyframe until tracking has already decayed (close points gone,
        # first new KF lands on a drifted pose, drift compounds).  Keeping
        # the stereo ratio at 0.75 from the start inserts KF1 while the
        # pose is still sharp.  SlamConfig.reference_exact() selects the
        # reference schedule instead.
        if self.config.optimizer.kf_ref_schedule == "reference":
            th_ref = 0.4 if n_kfs < 2 else 0.75
        else:
            th_ref = 0.75
        frames_since = frame.index - self._kf_frame_index()
        # mapping_idle: in online mode, whether the LocalMapping worker has
        # drained its queue (reference LocalMapping::AcceptKeyFrames).  The
        # offline pipeline is synchronous, so mapping is always idle there
        # and the schedule is unchanged.
        idle = self.mapping_idle_fn() if self.mapping_idle_fn else True
        c1a = frames_since >= self.max_frames
        # c1b requires Local Mapping idle (Tracking.cc:1101) — without the
        # gate, a backed-up mapping worker keeps receiving keyframes and
        # the tracking thread stalls behind its device dispatches
        c1b = frames_since >= self.min_frames and idle
        c1c = self.n_inliers < ref_matches * 0.25 or need_close
        c2 = (self.n_inliers < ref_matches * th_ref or need_close) and \
            self.n_inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if idle:
            return True
        # mapping busy: stereo inserts only while the queue is short
        # (Tracking.cc:1112-1121 KeyframesInQueue()<3)
        qlen = self.mapping_queue_len_fn() if self.mapping_queue_len_fn \
            else 0
        return qlen < 3

    def _kf_frame_index(self) -> int:
        kf = self.map.kfs.get(self.last_kf_id)
        return kf.frame_id if kf is not None else -10

    def _create_new_keyframe(self, frame: Frame):
        kf = KeyFrame(self.map.next_kf_id, frame)
        self.map.next_kf_id += 1
        self.map.add_keyframe(kf)
        frame.ref_kf_id = kf.id
        self.last_kf_id = kf.id

        pt = self.map.points
        # register existing matches as observations
        for fid in np.nonzero(frame.mp_idx >= 0)[0]:
            pid = int(frame.mp_idx[fid])
            if pid >= 0 and not pt.bad[pid]:
                self.map.add_observation(pid, kf, int(fid))

        # create close-depth points (sorted by depth, >=100)
        depths = frame.depth
        cand = np.nonzero((depths > 0) & frame.valid & (frame.mp_idx < 0))[0]
        if len(cand):
            order = cand[np.argsort(depths[cand])]
            created = []
            for fid in order:
                if depths[fid] > self.th_depth and len(created) >= 100:
                    break
                created.append(int(fid))
            if created:
                ids = np.asarray(created)
                pos = frame.unproject_features(ids)
                pids = self.map.create_points(kf, ids, pos)
                frame.mp_idx[ids] = pids
                if self.local_mapper is not None:
                    self.local_mapper.recent_points.extend(pids.tolist())

        if self.local_mapper is not None:
            self.local_mapper.process_new_keyframe(kf)
        else:
            self.map.update_connections(kf)

        if self.config.human.ok and frame.humans:
            self._grab_human_poses(frame, kf=kf)

    # ========================================================== humans
    def _grab_human_poses(self, frame: Frame, kf: Optional[KeyFrame]):
        """GrabHumanPoseKF / GrabHumanPose (Tracking.cc:1221-1293)."""
        vis = []
        ref_id = kf.id if kf is not None else \
            (frame.ref_kf_id if frame.ref_kf_id is not None else self.last_kf_id)
        for obs in frame.humans:
            joints_w = frame.unproject_human(obs)
            hp = HumanPose(
                track_id=obs.track_id, timestamp=frame.timestamp,
                kf_id=ref_id, joints_w=joints_w.astype(np.float32),
                bad=obs.bad.copy(), lost=np.zeros(18, bool),
                optimized=np.zeros(18, bool),
                obs_uvd=np.concatenate(
                    [obs.kp_left, obs.kp_right[:, :1], obs.depth[:, None]],
                    axis=1).astype(np.float32),
                confidence=obs.conf_left.copy(),
                in_keyframe=kf is not None)
            if obs.track_id >= 0:
                self.map.add_human_pose(hp)
                vis.append(obs.track_id)
        self.map.current_track_ids = vis

    # ========================================================== misc
    def _update_velocity(self, frame: Frame):
        lf = self.last_frame
        # a lost last frame carries a garbage pose — no usable velocity
        # (reference Tracking.cc:470: mVelocity = cv::Mat() when
        # mLastFrame.mTcw is empty)
        if lf is None or getattr(lf, "lost", False):
            self.velocity = None
            return
        # Tcl = Tcw_cur * Twc_last
        R = frame.Rcw @ lf.Rwc
        t = frame.Rcw @ lf.Ow + frame.tcw
        # Damped constant-velocity model.  The reference extrapolates the
        # raw last step (Tracking.cc:466-469, mVelocity) — benign at
        # 30 fps where prediction error is mm-scale and, at larger
        # motions, TrackWithMotionModel FAILS over to
        # TrackReferenceKeyFrame whose init is the LAST pose (no
        # extrapolation) — an accidental stabilizer.  At the 2-10 fps
        # cadence this framework targets, pose noise in weakly-observed
        # directions feeds the recurrence e_f = 2 e_{f-1} - e_{f-2}
        # (golden-ratio divergence, measured +3 -> +37 mm over 5 frames,
        # then runaway).  Scaling the extrapolated step by alpha < 1
        # turns the recurrence into e_f = (1+a) e_{f-1} - a e_{f-2},
        # stable for a < 1; alpha = 0.7 keeps 70 % of the prediction
        # benefit at a per-frame cost well inside the 2x matching-window
        # retry while bounding the feedback.
        a = float(self.config.optimizer.velocity_damping)
        if a < 1.0:
            from airdos_tpu.geometry.se3 import se3_exp_np, se3_log_np
            R, t = se3_exp_np(a * se3_log_np(R, t))
        self.velocity = (R.astype(np.float32), t.astype(np.float32))

    def _record_frame(self, frame: Frame):
        lost = self.state != TrackState.OK
        # while LOST, repeat the last relative pose instead of exporting
        # the failed frame's own (possibly garbage) pose — the reference
        # duplicates mlRelativeFramePoses.back() when tracking fails
        # (Tracking.cc:533-540; System.cc:361-364 `lbL` flag)
        if lost or frame.ref_kf_id is None \
                or frame.ref_kf_id not in self.map.kfs:
            if self.records:
                prev = self.records[-1]
                self.records.append(FrameRecord(prev.Tcr_R, prev.Tcr_t,
                                                prev.ref_kf_id, frame.timestamp,
                                                True))
            return
        ref = self.map.kfs[frame.ref_kf_id]
        # Tcr = Tcw * Twr
        R = frame.Rcw @ ref.Rwc
        t = frame.Rcw @ ref.Ow + frame.tcw
        self.records.append(FrameRecord(R.copy(), t.copy(), ref.id,
                                        frame.timestamp, lost))

    # ------------------------------------------------------------ export
    def trajectory_tum(self):
        """Camera trajectory via relative-pose chaining over (possibly
        re-optimized) keyframe poses (System::SaveTrajectoryTUM semantics)."""
        ts, Rwcs, twcs = [], [], []
        for rec in self.records:
            kf = self.map.kfs.get(rec.ref_kf_id)
            if kf is None:
                continue
            # walk up the spanning tree if the KF was culled, accumulating
            # T_acc = Tcp_1 * Tcp_2 * ... on the RIGHT (reference
            # System.cc:371: Trw = Trw * pKF->mTcp)
            Rrel = np.eye(3, dtype=np.float32)
            trel = np.zeros(3, np.float32)
            while kf.bad and kf.parent is not None and kf.Tcp is not None:
                Rt, tt = kf.Tcp
                Rrel, trel = Rrel @ Rt, Rrel @ tt + trel
                kf = self.map.kfs[kf.parent]
            Rcw = rec.Tcr_R @ Rrel @ kf.Rcw if not np.allclose(Rrel, np.eye(3)) \
                else rec.Tcr_R @ kf.Rcw
            tcw = rec.Tcr_R @ (Rrel @ kf.tcw + trel) + rec.Tcr_t \
                if not np.allclose(Rrel, np.eye(3)) \
                else rec.Tcr_R @ kf.tcw + rec.Tcr_t
            Rwc = Rcw.T
            twc = -Rcw.T @ tcw
            ts.append(rec.timestamp)
            Rwcs.append(Rwc)
            twcs.append(twc)
        return np.asarray(ts), np.asarray(Rwcs), np.asarray(twcs)
