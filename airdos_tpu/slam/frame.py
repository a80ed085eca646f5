"""Per-frame measurement construction.

Rebuild of the reference's Frame (src/Frame.cc): one jit-compiled device
program produces, from the raw stereo pair (+ masks), all padded measurement
arrays — ORB features both views, stereo matches (u_right/depth), and the
dense disparity map used for human association.  The host-side Frame object
wraps the results with numpy views plus map bookkeeping (per-feature map
point ids, pose).

Human-pose stereo association/triangulation follows
Frame::MatchingHumanPoses (src/Frame.cc:212-247) and
Frame::ComputeHumanPoseTriangulation (src/Frame.cc:313-416).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from airdos_tpu.config import SlamConfig
from airdos_tpu.features.orb import OrbExtractor
from airdos_tpu.geometry.camera import StereoCamera
from airdos_tpu.matching.stereo import stereo_match, stack_pyramid
from airdos_tpu.ops.disparity import patch_disparity
from airdos_tpu.ops.pyramid import build_pyramid, level_shapes
from airdos_tpu.slam.map import MAIN_SKELETON, N_JOINTS

MAX_HUMAN_DEPTH = 20.0      # reference rejects joint depth > 20 m
HUMAN_MATCH_TH = 30.0       # max mean torso distance for L/R association
MAX_HUMANS = 8              # padded per-frame human budget (device arrays)
N_TORSO = len(MAIN_SKELETON)


def torso_pixels(humans_left) -> np.ndarray:
    """[MAX_HUMANS * N_TORSO, 2] torso-joint pixels of the left detections,
    padded with (-1, -1) — the disparity-probe input of the frame program."""
    px = np.full((MAX_HUMANS * N_TORSO, 2), -1.0, np.float32)
    for li, L in enumerate(humans_left[:MAX_HUMANS]):
        for si, j in enumerate(MAIN_SKELETON):
            px[li * N_TORSO + si] = L[j, :2]
    return px


@dataclasses.dataclass
class HumanObservation:
    """One associated stereo human (reference: human_pose struct)."""
    track_id: int
    kp_left: np.ndarray      # [18, 2]
    kp_right: np.ndarray     # [18, 2]
    conf_left: np.ndarray    # [18]
    conf_right: np.ndarray   # [18]
    depth: np.ndarray        # [18]
    bad: np.ndarray          # [18] bool


class FrontEnd:
    """Owns the jitted frame-build program (one compile per image geometry)."""

    def __init__(self, config: SlamConfig):
        self.config = config
        cam = config.camera
        self.camera = StereoCamera.from_config(cam)
        orb = config.orb
        self.extractor = OrbExtractor(orb.n_features, orb.scale_factor,
                                      orb.n_levels, orb.ini_th_fast, orb.min_th_fast)
        self._widths = None
        self._build = jax.jit(self._build_impl, static_argnames=("with_disparity",))
        self._prefetched: dict = {}

    # ------------------------------------------------------------ uploads
    def _upload(self, data):
        """Async uint8 image (+mask) uploads (device_put returns
        immediately; uint8 — f32 costs ~4x on transfer)."""
        imL = jax.device_put(np.asarray(data.image_left, np.uint8))
        imR = jax.device_put(np.asarray(data.image_right, np.uint8))
        if self.config.system.is_mask and data.seg_left is not None:
            maskL = jax.device_put((data.seg_left == 0).astype(np.uint8))
            maskR = jax.device_put((data.seg_right == 0).astype(np.uint8))
        else:
            maskL = maskR = None
        return imL, imR, maskL, maskR

    def prefetch(self, data):
        """Start the next frame's uploads early so the host-to-device
        transfer overlaps the current frame's device compute (the
        reference's IO thread reads images ahead; here the copy engine is
        the overlap axis).  Only the newest prefetch is kept."""
        if data.index not in self._prefetched:
            self._prefetched = {data.index: self._upload(data)}

    def uploads(self, data):
        """This frame's device images: prefetched if available."""
        arrs = self._prefetched.pop(data.index, None)
        return arrs if arrs is not None else self._upload(data)

    def _build_impl(self, imL, imR, maskL, maskR, torso_px,
                    with_disparity: bool):
        cfg = self.config
        orb = cfg.orb
        imL = imL.astype(jnp.float32)
        imR = imR.astype(jnp.float32)
        maskL = maskL.astype(jnp.float32)
        maskR = maskR.astype(jnp.float32)
        h, w = imL.shape
        pyrL = build_pyramid(imL, maskL, orb.n_levels, orb.scale_factor)
        pyrR = build_pyramid(imR, maskR, orb.n_levels, orb.scale_factor)
        fL = self.extractor._extract_from_pyramid(pyrL)
        fR = self.extractor._extract_from_pyramid(pyrR)
        widths = jnp.asarray([s[1] for s in level_shapes(h, w, orb.n_levels,
                                                         orb.scale_factor)], jnp.int32)
        scales = jnp.asarray(self.extractor.scales, jnp.float32)
        sm = stereo_match(fL.xy, fL.octave, fL.desc32, fL.valid,
                          fR.xy, fR.octave, fR.desc32, fR.valid,
                          stack_pyramid(pyrL.images), stack_pyramid(pyrR.images),
                          widths, scales,
                          jnp.float32(cfg.camera.bf),
                          jnp.float32(cfg.camera.baseline))
        xy_un = self.camera.undistort_points(fL.xy)
        # disparity only at the torso-joint probe pixels (association
        # guidance) — never a dense map (reference Frame.cc:323-336 runs
        # full-image SGBM; see ops/disparity.patch_disparity docstring)
        disp = patch_disparity(imL, imR, torso_px) if with_disparity \
            else jnp.zeros((1,))
        return fL, fR, sm, xy_un, disp

    def build_frame(self, data, index: int = None) -> "Frame":
        """data: io.datasets.FrameData."""
        cfg = self.config
        # uint8 uploads — the device program casts to f32; seg nonzero =
        # dynamic -> usable mask is (seg == 0)
        imL, imR, maskL, maskR = self.uploads(data)
        if maskL is None:
            maskL = jnp.ones((cfg.camera.height, cfg.camera.width), jnp.uint8)
            maskR = maskL
        use_gt_depth = cfg.system.is_ground_truth_depth and data.depth is not None
        want_disp = bool(cfg.human.ok and data.humans_left is not None
                         and len(data.humans_left) > 0 and not use_gt_depth)
        torso_px = torso_pixels(data.humans_left) if want_disp else \
            np.full((MAX_HUMANS * N_TORSO, 2), -1.0, np.float32)
        fL, fR, sm, xy_un, disp = self._build(imL, imR, maskL, maskR,
                                              jnp.asarray(torso_px),
                                              with_disparity=want_disp)
        frame = Frame(self, data, fL, fR, sm, xy_un,
                      disp if want_disp else None)
        return frame


class Frame:
    """Host-side frame: numpy measurement views + map bookkeeping."""

    def __init__(self, frontend: FrontEnd, data, fL, fR, sm, xy_un_dev,
                 disparity_dev):
        dev = dict(xy=fL.xy, xy_un=xy_un_dev, octave=fL.octave,
                   angle=fL.angle, desc32=fL.desc32, valid=fL.valid,
                   u_right=sm.u_right, depth=sm.depth)
        host = jax.device_get((fL.xy, fL.response, fL.angle, fL.octave,
                               fL.desc32, fL.valid, sm.u_right, sm.depth,
                               xy_un_dev, disparity_dev))
        self._init_from_arrays(frontend, data, dev, host)

    @classmethod
    def from_track_result(cls, frontend: FrontEnd, data, host):
        """Build from a device_get'd packed FullTrackResult."""
        self = cls.__new__(cls)
        f32 = host.feat_f32
        i32 = host.feat_i32
        disp = host.disparity if host.disparity.shape[0] > 1 else None
        host_tuple = (f32[:, 0:2], f32[:, 4], f32[:, 5],
                      i32[:, 0], host.desc32, i32[:, 1] > 0,
                      f32[:, 6], f32[:, 7], f32[:, 2:4], disp)
        # dev handles are rebuilt lazily from host copies (fallback paths
        # only) — the fused fast path never needs them
        self._init_from_arrays(frontend, data, None, host_tuple)
        return self

    @property
    def dev(self):
        if self._dev is None:
            self._dev = dict(
                xy=jnp.asarray(self.xy), xy_un=jnp.asarray(self.xy_un),
                octave=jnp.asarray(self.octave), angle=jnp.asarray(self.angle),
                desc32=jnp.asarray(self.desc32), valid=jnp.asarray(self.valid),
                u_right=jnp.asarray(self.u_right),
                depth=jnp.asarray(self.depth))
        return self._dev

    def _init_from_arrays(self, frontend: FrontEnd, data, dev, host):
        self.frontend = frontend
        self.config = frontend.config
        self.camera = frontend.camera
        self.index = data.index
        self.timestamp = data.timestamp
        self._dev = dev
        (self.xy, self.response, self.angle, self.octave, self.desc32,
         self.valid, self.u_right, self.depth, self.xy_un, disparity) = host
        self.octave = np.ascontiguousarray(self.octave).astype(np.int32)
        self.desc32 = np.ascontiguousarray(self.desc32)
        self.xy = np.ascontiguousarray(self.xy)
        self.xy_un = np.ascontiguousarray(self.xy_un)
        self.n_slots = self.xy.shape[0]
        self.mp_idx = np.full(self.n_slots, -1, np.int64)
        self.outlier = np.zeros(self.n_slots, bool)

        # pose Tcw
        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)
        self.ref_kf_id: Optional[int] = None

        # humans
        self.humans: list[HumanObservation] = []
        if self.config.system.is_ground_truth_depth and \
                data.depth is not None and data.humans_left is not None:
            self._humans_from_depth(data)
        elif disparity is not None and data.humans_left is not None:
            self._associate_humans(data, disparity)

    # ------------------------------------------------------------- pose
    def set_pose(self, Rcw, tcw):
        # re-orthonormalize: solver output carries f32 drift that otherwise
        # compounds through the velocity composition (see project_so3_np)
        from airdos_tpu.geometry.se3 import project_so3_np
        self.Rcw = project_so3_np(Rcw).astype(np.float32)
        self.tcw = np.asarray(tcw, np.float32)

    @property
    def Rwc(self):
        return self.Rcw.T

    @property
    def Ow(self):
        return -self.Rcw.T @ self.tcw

    # ------------------------------------------------------------ humans
    def _humans_from_depth(self, data):
        """RGB-D human joints: depth read straight off the registered depth
        image, pseudo right keypoint u - bf/d (System.IsGroundTruthDepth;
        reference Frame::ComputeHumanPoseDepth, Frame.cc:249-311)."""
        cfg = self.config
        bf = float(cfg.camera.bf)
        reject_th = cfg.human.reject_th
        depth_im = data.depth
        h, w = depth_im.shape[:2]
        tids = data.track_ids
        for li, L in enumerate(data.humans_left):
            tid = int(tids[li]) if tids is not None and li < len(tids) else -1
            if tids is not None and li < len(tids) and tid < 0:
                continue
            depth = np.zeros(N_JOINTS, np.float32)
            bad = np.zeros(N_JOINTS, bool)
            kp_r = np.zeros((N_JOINTS, 2), np.float32)
            for j in range(N_JOINTS):
                u, v = L[j, 0], L[j, 1]
                ui = int(np.clip(u, 0, w - 1))
                vi = int(np.clip(v, 0, h - 1))
                d = float(depth_im[vi, ui])
                b = False
                if d < 0.01:
                    b = True
                    d = 0.01
                if L[j, 2] < reject_th:
                    b = True
                depth[j] = d
                bad[j] = b
                kp_r[j] = (u - bf / d, v)
            self.humans.append(HumanObservation(
                track_id=tid,
                kp_left=L[:, :2].astype(np.float32),
                kp_right=kp_r,
                conf_left=L[:, 2].astype(np.float32),
                conf_right=np.ones(N_JOINTS, np.float32),
                depth=depth, bad=bad))

    def _associate_humans(self, data, joint_disp: np.ndarray):
        """Greedy left->right association via disparity-compensated torso
        distance, then per-joint triangulation (reference semantics).

        joint_disp: [MAX_HUMANS * N_TORSO] disparity probed at the left
        detections' torso joints (see torso_pixels)."""
        cfg = self.config
        cam = self.camera
        bf = float(cfg.camera.bf)
        reject_th = cfg.human.reject_th
        h, w = data.image_left.shape[:2]
        left, right = data.humans_left, data.humans_right
        tids = data.track_ids
        n = min(len(left), len(right)) if len(right) else 0
        for li in range(min(len(left), n, MAX_HUMANS)):
            tid = int(tids[li]) if tids is not None and li < len(tids) else -1
            if tids is not None and li < len(tids) and tid < 0:
                continue  # untrackable pose
            L = left[li]
            best_rid, best_dist = -1, 50.0
            for ri in range(len(right)):
                dsum, cnt = 0.0, 0
                for si, j in enumerate(MAIN_SKELETON):
                    sl, sr = L[j, 2], right[ri][j, 2]
                    ul, vl = L[j, 0], L[j, 1]
                    if sl < reject_th and sr < reject_th:
                        continue
                    if not (0 <= ul < w and 0 <= vl < h):
                        continue
                    d = float(joint_disp[li * N_TORSO + si])
                    d = max(d, 0.0)
                    dx = ul - d - right[ri][j, 0]
                    dy = vl - right[ri][j, 1]
                    dsum += np.hypot(dx, dy)
                    cnt += 1
                if cnt == 0:
                    continue
                dsum /= cnt
                if dsum < best_dist:
                    best_dist, best_rid = dsum, ri
            if best_rid < 0 or best_dist >= HUMAN_MATCH_TH:
                continue
            R = right[best_rid]
            depth = np.zeros(N_JOINTS, np.float32)
            bad = np.zeros(N_JOINTS, bool)
            for j in range(N_JOINTS):
                b = L[j, 2] < reject_th and R[j, 2] < reject_th
                disp = L[j, 0] - R[j, 0]
                if disp <= 0:
                    disp = 0.01
                    b = True
                z = bf / disp
                if z > MAX_HUMAN_DEPTH:
                    b = True
                depth[j] = z
                bad[j] = b
            self.humans.append(HumanObservation(
                track_id=tid,
                kp_left=L[:, :2].astype(np.float32),
                kp_right=np.stack([R[:, 0], L[:, 1]], axis=1).astype(np.float32),
                conf_left=L[:, 2].astype(np.float32),
                conf_right=R[:, 2].astype(np.float32),
                depth=depth, bad=bad))

    def unproject_human(self, obs: HumanObservation) -> np.ndarray:
        """Joint world positions [18, 3] from left pixels + depth."""
        cam = self.config.camera
        x = (obs.kp_left[:, 0] - cam.cx) * obs.depth / cam.fx
        y = (obs.kp_left[:, 1] - cam.cy) * obs.depth / cam.fy
        xc = np.stack([x, y, obs.depth], axis=1)
        return (self.Rwc @ xc.T).T + self.Ow[None, :]

    def unproject_feature(self, i: int) -> np.ndarray:
        cam = self.config.camera
        z = self.depth[i]
        x = (self.xy_un[i, 0] - cam.cx) * z / cam.fx
        y = (self.xy_un[i, 1] - cam.cy) * z / cam.fy
        xc = np.array([x, y, z], np.float32)
        return self.Rwc @ xc + self.Ow

    def unproject_features(self, ids: np.ndarray) -> np.ndarray:
        cam = self.config.camera
        z = self.depth[ids]
        x = (self.xy_un[ids, 0] - cam.cx) * z / cam.fx
        y = (self.xy_un[ids, 1] - cam.cy) * z / cam.fy
        xc = np.stack([x, y, z], axis=1).astype(np.float32)
        return (self.Rwc @ xc.T).T + self.Ow[None, :]
