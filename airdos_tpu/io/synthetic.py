"""Synthetic stereo world for tests and benchmarks.

Renders a static point-sprinkled world plus articulated walking "humans"
(18-joint skeletons with AlphaPose-style observations), from a known camera
trajectory — giving ground truth for every quantity the SLAM system
estimates (camera poses, point depths, joint positions, limb lengths,
per-human SE(3) motion).  Used in place of TartanAir-Shibuya in
dataset-free environments.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from airdos_tpu.config import CameraConfig, SlamConfig
from airdos_tpu.io.datasets import FrameData
from airdos_tpu.io.raster import draw_line, fill_circle

# 18-joint AlphaPose/COCO-ish skeleton used by the reference (Map.h:48-56):
# segment endpoints body1/body2 define the 14 rigid parts.
BODY1 = np.array([1, 1, 2, 3, 1, 5, 6, 2, 8, 9, 5, 11, 12, 1], np.int32)
BODY2 = np.array([0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 1], np.int32)
MAIN_SKELETON = np.array([1, 2, 5, 11, 8], np.int32)
N_JOINTS = 18
N_PARTS = 14

# a plausible upright skeleton (x right, y DOWN, z forward), metres
_SKELETON_REST = np.array([
    [0.00, -0.70, 0.00],   # 0 nose
    [0.00, -0.50, 0.00],   # 1 neck
    [-0.20, -0.50, 0.00],  # 2 r shoulder
    [-0.25, -0.25, 0.00],  # 3 r elbow
    [-0.28, 0.00, 0.00],   # 4 r wrist
    [0.20, -0.50, 0.00],   # 5 l shoulder
    [0.25, -0.25, 0.00],   # 6 l elbow
    [0.28, 0.00, 0.00],    # 7 l wrist
    [-0.12, 0.10, 0.00],   # 8 r hip
    [-0.14, 0.50, 0.00],   # 9 r knee
    [-0.15, 0.90, 0.00],   # 10 r ankle
    [0.12, 0.10, 0.00],    # 11 l hip
    [0.14, 0.50, 0.00],    # 12 l knee
    [0.15, 0.90, 0.00],    # 13 l ankle
    [-0.04, -0.73, 0.00],  # 14 r eye
    [0.04, -0.73, 0.00],   # 15 l eye
    [-0.08, -0.70, 0.00],  # 16 r ear
    [0.08, -0.70, 0.00],   # 17 l ear
], np.float64)


def default_camera() -> CameraConfig:
    """Mirrors the TartanAir-Shibuya rig (tartanair.yaml): 640x360,
    fx 772.5, baseline 0.25 m."""
    return CameraConfig(fx=772.5483, fy=772.5483, cx=320.0, cy=180.0,
                        width=640, height=360, bf=193.1371, fps=10.0)


def small_camera() -> CameraConfig:
    """Low-res camera for cheap CPU tests."""
    return CameraConfig(fx=320.0, fy=320.0, cx=160.0, cy=120.0,
                        width=320, height=240, bf=80.0, fps=10.0)


@dataclasses.dataclass
class SyntheticHuman:
    track_id: int
    start_pos: np.ndarray       # world position of the neck at t=0
    velocity: np.ndarray        # m/s, constant (the AirDOS motion model)
    scale: float = 1.0          # body size multiplier

    def joints_at(self, t: float) -> np.ndarray:
        """[18, 3] world joint positions; limbs swing slightly but segment
        lengths stay constant (rigidity)."""
        base = self.start_pos + self.velocity * t
        joints = _SKELETON_REST * self.scale
        joints = joints + base[None, :]
        return joints


class SyntheticStereoWorld:
    def __init__(self, seed: int = 0, n_points: int = 12000,
                 cam: Optional[CameraConfig] = None,
                 n_humans: int = 0,
                 world_size: Tuple[float, float, float] = (24.0, 8.0, 40.0),
                 centered: bool = False,
                 clear_ring: Optional[Tuple[float, float, float, float]] = None,
                 ring_outside_only: bool = False,
                 room_radius: Optional[float] = None,
                 corridor_walls: Optional[float] = None,
                 crowd: bool = False,
                 pillar: Optional[Tuple[float, float, float, int]] = None):
        """centered=True scatters landmarks/billboards all around the
        origin (for closed-loop trajectories); default is a corridor
        along +z (forward-motion sequences).  clear_ring=(cx, cz, r, hw)
        keeps landmarks at least hw away from the circular path of radius
        r centred at (cx, cz) in the xz-plane (loop_trajectory's track)."""
        self.rng = np.random.default_rng(seed)
        self.cam = cam or default_camera()
        self.centered = centered
        wx, wy, wz = world_size
        if centered:
            if clear_ring is not None:
                # place landmarks in an annulus hugging the circular track
                # (offset quadratically biased close) so the camera always
                # has well-constrained close structure in view, with the
                # track cylinder itself kept clear of fly-through features
                cx0, cz0, r0, hw = clear_ring
                ang = self.rng.uniform(0, 2 * np.pi, n_points)
                sign = np.ones(n_points) if ring_outside_only else \
                    self.rng.choice([-1.0, 1.0], n_points)
                # keep dots INSIDE the room walls: a dot beyond a wall
                # renders through it (no occlusion), giving a stereo-
                # consistent but geometrically-impossible landmark
                max_off = wz / 2 - hw
                if room_radius is not None:
                    max_off = min(max_off, room_radius - r0 - 0.35)
                off = (hw + max_off *
                       self.rng.uniform(0, 1, n_points) ** 2) * sign
                rr = np.maximum(r0 + off, 0.3)
                pts = np.stack([
                    cx0 + rr * np.cos(ang),
                    self.rng.uniform(-wy / 2, wy / 2, n_points),
                    cz0 + rr * np.sin(ang),
                ], axis=1)
            else:
                pts = np.stack([
                    self.rng.uniform(-wx / 2, wx / 2, n_points),
                    self.rng.uniform(-wy / 2, wy / 2, n_points),
                    self.rng.uniform(-wz / 2, wz / 2, n_points),
                ], axis=1)
            self.points = pts
        else:
            # static landmarks in a corridor along +z; depth quadratically
            # biased toward close range so a moving camera always sees
            # well-constrained (<~9 m) structure, like real street scenes —
            # a uniform-depth world leaves stereo z almost unconstrained.
            # The camera's own path cylinder (|x| < 0.7) is kept clear: a
            # dot the camera flies through sweeps ~80 px/frame, mismatches
            # to its neighbours inside the search window, and its (accurate,
            # high-information) depth lets it hijack the pose solve.  The
            # band must stay narrow — with a 22.5 deg half-FOV, a dot at
            # |x|=1.5 only enters view beyond z=3.6 m, and a wider clearance
            # leaves NO close features in the central image at all.
            zmax = min(wz, 25.0)
            xs = self.rng.uniform(-wx / 2, wx / 2, n_points)
            band = np.abs(xs) < 0.7
            xs[band] = np.sign(xs[band]) * (0.7 + np.abs(xs[band]))
            if corridor_walls is not None:
                # fold dots into the slab between the clear band and the
                # walls — a dot beyond a wall would render through it
                # (no occlusion) as a geometrically-impossible landmark
                slab = max(corridor_walls - 0.3 - 0.7, 0.2)
                xs = np.sign(xs) * (0.7 + np.mod(np.abs(xs) - 0.7, slab))
            self.points = np.stack([
                xs,
                self.rng.uniform(-wy / 2, wy / 2, n_points),
                0.5 + (zmax - 0.5) * self.rng.uniform(0, 1, n_points) ** 2,
            ], axis=1)
        self.intensity = self.rng.uniform(60, 255, n_points)
        # physical dot radius (m) -> projected size scales with 1/depth, so
        # feature appearance is scale-consistent across the pyramid
        self.phys_radius = self.rng.uniform(0.03, 0.20, n_points)
        # each dot gets an asymmetric satellite blob (fixed 3-D offset) so
        # the intensity-centroid orientation is well-defined and
        # view-consistent — symmetric dots would have noise-driven angles
        # and uncorrelated descriptors across views
        dirs = self.rng.standard_normal((n_points, 3))
        dirs[:, 2] *= 0.1
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        self.sat_offset = dirs * self.phys_radius[:, None] * 0.9
        self.sat_intensity = np.clip(self.intensity * self.rng.uniform(0.3, 0.6, n_points), 30, 255)
        # fronto-parallel textured billboards at mixed depths: the main
        # source of high-quality stereo matches (ground/wall patches shear
        # between the stereo views; these don't)
        # billboard = (axis, a0, y0, c0, bw, bh, seed): a plane with normal
        # along `axis` (0 = x-plane, 2 = z-plane) at coordinate c0; (a0, y0)
        # is the patch centre in the in-plane axes
        self.billboards = []
        if centered and clear_ring is not None:
            # textured ROOM around the ring track: four full-height walls.
            # A bare dot field is self-similar — under LATERAL motion a
            # dot mismatched to its neighbour along the flow direction is
            # consistent with a wrong translation and hijacks the pose
            # (the corridor world's billboards are what make it stable).
            # Unique hashed wall texture at 3-7 m gives the strafing
            # camera corridor-quality stereo matches at every heading.
            cx0, cz0, r0, _hw = clear_ring
            # room_radius = wall half-size from the ring center.  CLOSE
            # walls matter: floating dots carry mostly-background BRIEF
            # patches whose content is rewritten every frame by close-range
            # parallax (descriptors go stale within ~5 frames, Hamming
            # >100); wall texture is a surface — its patches are parallax-
            # free and stay matchable for the whole lap
            wall_r = room_radius if room_radius is not None else r0 + 3.2
            span = 2 * wall_r + 2.0
            for wi, (axis, c0) in enumerate([
                    (0, cx0 - wall_r), (0, cx0 + wall_r),
                    (2, cz0 - wall_r), (2, cz0 + wall_r)]):
                a0 = cz0 if axis == 0 else cx0
                self.billboards.append((axis, a0, 0.2, c0, span, 5.0,
                                        900 + wi))
                # depth RELIEF on each wall (shelves/furniture standoff):
                # headings where a bare wall fills the whole FOV are the
                # fronto-parallel-plane degeneracy — every feature at one
                # depth leaves a yaw <-> lateral-translation mode the
                # pose solve cannot pin (measured 4-12 deg yaw drift the
                # moment the matched-depth spread collapsed to one wall).
                # Patches 0.15-0.5 m in front of the wall give every view
                # a two-depth structure that closes the mode.
                for rj in range(8):
                    standoff = float(self.rng.uniform(0.15, 0.5))
                    aa = a0 + float(self.rng.uniform(-wall_r, wall_r))
                    yy = float(self.rng.uniform(-0.5, 0.9))
                    ww = float(self.rng.uniform(0.4, 1.0))
                    hh = float(self.rng.uniform(0.4, 1.0))
                    cc = c0 - np.sign(c0 - (cx0 if axis == 0 else cz0)) \
                        * standoff
                    self.billboards.append(
                        (axis, aa, yy, cc, ww, hh, 700 + 8 * wi + rj))
        if centered:
            for k in range(120):
                axis = 2 if k % 2 == 0 else 0
                c0 = self.rng.uniform(2.0, wz / 2) * self.rng.choice([-1, 1])
                a0 = self.rng.uniform(-wx / 2, wx / 2)
                y0 = self.rng.uniform(-0.6, 1.0)
                bw = self.rng.uniform(0.6, 1.8)
                bh = self.rng.uniform(0.6, 1.8)
                if clear_ring is not None:
                    # keep billboards away from the ring path: a surface
                    # passing within ~1 m of the strafing camera fills half
                    # the FOV with ~33 px/frame self-similar flow and
                    # occludes the stable far scene — measured to break
                    # tracking at the same ring angle on every lap speed
                    cx0, cz0, r0, hw = clear_ring
                    pts2 = [(a0 - bw / 2, c0), (a0, c0), (a0 + bw / 2, c0)] \
                        if axis == 2 else \
                        [(c0, a0 - bw / 2), (c0, a0), (c0, a0 + bw / 2)]
                    dmin = min(abs(np.hypot(px - cx0, pz - cz0) - r0)
                               for px, pz in pts2)
                    if dmin < hw + 0.25:
                        continue
                self.billboards.append((axis, a0, y0, c0, bw, bh, 100 + k))
        else:
            if corridor_walls is not None:
                # long textured side walls: the continuous CLOSE structure
                # real corridors/streets have.  Without them the visible
                # depth distribution is far-dominated (close dots have a
                # tiny visibility wedge around the cleared camera path) and
                # forward translation becomes unobservable: a 0.24 m axial
                # slip moves a 25 m point by 3 px and its stereo disparity
                # by 0.03 px, so pose LM sits in a flat valley wherever the
                # motion prediction drops it, the slip feeds the constant-
                # velocity model, and the error doubles every frame
                # (measured: -0.026 -> -0.068 -> -0.240 -> -0.799 m, pure
                # z, rotation 0.00 deg).  Wall texture at ~2 m anchors z at
                # every frame the way real scenes do.
                for wi, xw in enumerate((-corridor_walls, corridor_walls)):
                    self.billboards.append(
                        (0, wz / 4, 0.2, xw, wz / 2 + 6.0, 5.0, 900 + wi))
            for k in range(60):
                z0 = self.rng.uniform(2.5, 28.0)
                x0 = self.rng.uniform(-0.45, 0.45) * (2.0 + z0 * 0.8)
                if corridor_walls is not None and z0 < 9.0:
                    # keep close billboards inside the walls
                    x0 = np.clip(x0, -(corridor_walls - 0.9),
                                 corridor_walls - 0.9)
                bw = self.rng.uniform(0.5, 1.6)
                bh = self.rng.uniform(0.5, 1.6)
                # keep near-range billboards (their full width) clear of the
                # camera corridor so the camera never brushes past a giant
                # close plane
                if z0 < 9.0 and abs(x0) - bw / 2 < 1.4:
                    x0 = np.sign(x0 or 1.0) * (1.4 + bw / 2 + abs(x0) * 0.3)
                y0 = self.rng.uniform(-0.6, 1.0)
                self.billboards.append((2, x0, y0, z0, bw, bh, 100 + k))
        self.billboards.sort(key=lambda b: -abs(b[3]))   # far to near
        # oriented billboards: (nvec, d0, tvec, a0, y0, bw, bh, seed) — a
        # plane {p : p.nvec = d0} with in-plane horizontal axis tvec and
        # vertical axis ey; the z-buffered render pass makes no
        # axis-alignment assumption.  Used for the loop-closure pillar: an
        # n_faces prism of frontal textured faces at the orbit center.  A
        # camera orbiting the prism always has a near-frontal surface in
        # view (stereo-matchable: no slant shear, no dot parallax inside
        # the BRIEF patch), each face is visible for only ~2/n_faces of the
        # lap (covisibility with the lap start genuinely decays), and every
        # face carries a distinct texture seed (the revisit's BoW query is
        # discriminative).
        self.oriented_billboards: List[tuple] = []
        if pillar is not None:
            pcx, pcz, prad, n_faces = pillar
            apothem = prad * np.cos(np.pi / n_faces)
            face_w = 2.0 * prad * np.sin(np.pi / n_faces)
            pc = np.array([pcx, 0.0, pcz])
            for fi in range(n_faces):
                phi = 2 * np.pi * fi / n_faces
                nvec = np.array([np.cos(phi), 0.0, np.sin(phi)])
                tvec = np.array([-np.sin(phi), 0.0, np.cos(phi)])
                self.oriented_billboards.append(
                    (nvec, float(pc @ nvec) + apothem, tvec,
                     float(pc @ tvec), 0.0, face_w, 2.4, 530 + fi))
        # unified per-render surface list in (nvec, d0, tvec, ...) plane
        # form, ordered near-to-far (pillar faces, then billboards by
        # |plane offset|): the z-buffer makes order irrelevant for OUTPUT,
        # but near-first lets far surfaces skip already-covered pixels
        _ex = np.array([1.0, 0.0, 0.0])
        _ez = np.array([0.0, 0.0, 1.0])
        self._surfaces = list(self.oriented_billboards)
        for (axis, a0, y0, c0, bw, bh, seed) in sorted(
                self.billboards, key=lambda b: abs(b[3])):
            nvec = _ex if axis == 0 else _ez
            tvec = _ez if axis == 0 else _ex
            self._surfaces.append((nvec, float(c0), tvec, float(a0),
                                   float(y0), bw, bh, seed))
        self.humans: List[SyntheticHuman] = []
        if crowd:
            # Shibuya-crossing mode: a dense, SLOW, coherently-drifting
            # crowd filling the camera's forward view.  Slow coherent
            # motion is the adversarial regime for an unmasked pipeline:
            # crowd features flow only ~1-2 px/frame, INSIDE the pose
            # optimizer's chi-square inlier gate, so instead of being
            # rejected as outliers they bias the camera solve a little
            # every frame and the error compounds (the failure AirDOS
            # exists to fix; fast movers are trivially gated out).
            drift = self.rng.uniform(0, 2 * np.pi)
            dvec = np.array([np.cos(drift), 0.0, 0.15 * np.sin(drift)])
            # the adversarial regime is defined in PIXELS (flow inside the
            # ~2.4 px chi-square gate): scale metric speed with 1/fx so the
            # same pixel flow arises at any rendering resolution
            px_scale = 772.5 / self.cam.fx
            for k in range(n_humans):
                frac = k / max(n_humans - 1, 1)
                z0 = 2.6 + 6.0 * frac
                # spread across the visible corridor width at that depth
                half_w = 0.42 * z0
                x0 = self.rng.uniform(-half_w, half_w)
                if abs(x0) < 0.9:          # keep the fly-through band clear
                    x0 = np.sign(x0 or 1.0) * 0.9
                pos = np.array([x0, 0.0, z0 + self.rng.uniform(-0.8, 0.8)])
                speed = self.rng.uniform(0.04, 0.14) * px_scale
                vel = speed * (dvec + self.rng.normal(0, 0.12, 3) *
                               np.array([1.0, 0.0, 1.0]))
                self.humans.append(SyntheticHuman(
                    k, pos, vel, scale=self.rng.uniform(1.1, 1.4)))
        else:
            for k in range(n_humans):
                # walk ACROSS the camera's corridor at close-ish range so
                # the unmasked static pipeline ingests moving texture
                side = -1.0 if k % 2 == 0 else 1.0
                pos = np.array([side * self.rng.uniform(1.5, 3.0), 0.0,
                                self.rng.uniform(4.5, 11.0)])
                vel = np.array([-side * self.rng.uniform(0.2, 0.45), 0.0,
                                self.rng.uniform(-0.2, 0.2)])
                self.humans.append(SyntheticHuman(k, pos, vel))

    # ---------------------------------------------------------------- poses
    def trajectory(self, n_frames: int, dt: float = 0.1,
                   speed: float = 0.5, yaw_rate: float = 0.02):
        """Forward motion with gentle yaw.  Returns (Rwc, twc) lists: pose of
        camera in world (camera-to-world)."""
        Rwc, twc = [], []
        pos = np.zeros(3)
        yaw = 0.0
        for i in range(n_frames):
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            Rwc.append(R)
            twc.append(pos.copy())
            pos = pos + R @ np.array([0, 0, speed * dt])
            yaw += yaw_rate
        return np.asarray(Rwc), np.asarray(twc)

    def loop_trajectory(self, n_frames: int, radius: float = 4.0,
                        laps: float = 1.05):
        """Closed circular trajectory in the xz-plane, heading tangent: the
        camera returns to (and slightly past) its start pose — the loop-
        closure test case.  Returns (Rwc, twc)."""
        Rwc, twc = [], []
        for i in range(n_frames):
            th = 2 * np.pi * laps * i / n_frames
            pos = np.array([radius * (1 - np.cos(th)), 0.0,
                            radius * np.sin(th)])
            c, s = np.cos(th), np.sin(th)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            Rwc.append(R)
            twc.append(pos)
        return np.asarray(Rwc), np.asarray(twc)

    def orbit_loop_trajectory(self, n_frames: int, radius: float = 1.35,
                              laps: float = 1.1):
        """Closed loop with the camera ORBITING its ring facing the ring
        center: the classic well-conditioned object-scan motion (the
        cleared path tube is never in view, close structure never flies
        by), while the visible far side rotates with the camera so
        covisibility with the start decays mid-lap and revisiting the
        start pose is a genuine loop-closure event.  Heading rotates
        uniformly (2*pi*laps/n_frames per frame).  Returns (Rwc, twc)."""
        Rwc, twc = [], []
        for i in range(n_frames):
            th = 2 * np.pi * laps * i / n_frames
            pos = np.array([radius * (1 - np.cos(th)), 0.0,
                            radius * np.sin(th)])
            yaw = th + np.pi / 2           # look dir = (cos th, 0, -sin th)
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            Rwc.append(R)
            twc.append(pos)
        return np.asarray(Rwc), np.asarray(twc)

    def walk_loop_trajectory(self, n_frames: int, radius: float = 1.35,
                             laps: float = 1.1, look_in: float = 0.0):
        """Closed loop WALKING the ring facing the tangent (velocity)
        direction — the natural walk-around-the-block loop: the room's
        outer wall rides alongside at constant close range (persistent
        close SURFACE structure at every heading, which facing-center
        orbits never have in view), while the path ahead curves through
        previously unseen wall/dot texture until the revisit.  look_in
        tilts the heading toward the ring center (radians).  Returns
        (Rwc, twc)."""
        Rwc, twc = [], []
        for i in range(n_frames):
            th = 2 * np.pi * laps * i / n_frames
            pos = np.array([radius * (1 - np.cos(th)), 0.0,
                            radius * np.sin(th)])
            yaw = th + look_in          # tangent dir = (sin th, 0, cos th)
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            Rwc.append(R)
            twc.append(pos)
        return np.asarray(Rwc), np.asarray(twc)

    def strafe_loop_trajectory(self, n_frames: int, radius: float = 4.0,
                               laps: float = 1.1, yaw_amp: float = 0.0):
        """Closed circular loop with (near-)constant heading: the camera
        STRAFES around the circle facing +z, optionally swinging its yaw
        sinusoidally by up to yaw_amp radians mid-loop (returning to 0 at
        the revisit).  Unlike the tangent-heading loop_trajectory there is
        no sustained per-frame rotation, so the motion-model matcher stays
        well inside its search window the whole lap — the trackable
        testbed for image-level loop closure.  Returns (Rwc, twc)."""
        Rwc, twc = [], []
        for i in range(n_frames):
            th = 2 * np.pi * laps * i / n_frames
            pos = np.array([radius * (1 - np.cos(th)), 0.0,
                            radius * np.sin(th)])
            # yaw ramps 0 -> yaw_amp at mid-loop -> back to 0 at the
            # revisit: maximum heading decorrelation from the start view
            # exactly when covisibility should break, at HALF the peak
            # yaw rate of a sin(th) swing
            yaw = yaw_amp * 0.5 * (1.0 - np.cos(th))
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            Rwc.append(R)
            twc.append(pos)
        return np.asarray(Rwc), np.asarray(twc)

    # ---------------------------------------------------------------- render
    def _project(self, Rcw, tcw, pts):
        xc = (Rcw @ pts.T).T + tcw
        z = xc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = self.cam.fx * xc[:, 0] / z + self.cam.cx
            v = self.cam.fy * xc[:, 1] / z + self.cam.cy
        return u, v, z

    @staticmethod
    def _value_noise(x: np.ndarray, z: np.ndarray, seed: int,
                     footprint: Optional[np.ndarray] = None) -> np.ndarray:
        """Deterministic texture in [0, 1] at world coords.

        The sharp block octave is mip-selected per pixel: block size is the
        smallest of {base * 2^k} that is at least ~2.5x the pixel footprint,
        so distant texture never aliases (aliasing would decorrelate the
        stereo views and poison descriptor matching)."""
        def hashed(xi, zi, s_off):
            # uint32 wraparound arithmetic == the reference int64-then-mask
            # formulation bit for bit (two's complement), at half the memory
            # traffic — this function dominated render cost
            v = (xi * np.uint32(73856093)) ^ (zi * np.uint32(19349663)) ^ \
                np.uint32(((seed + s_off) * 83492791) & 0xFFFFFFFF)
            v = (v ^ (v >> np.uint32(13))) * np.uint32(1274126177)
            return ((v ^ (v >> np.uint32(16))) & np.uint32(0xFF)) \
                .astype(np.float32) / np.float32(255.0)

        def vnoise(xs, zs, sc, s_off):
            """Smoothstep-interpolated lattice noise at cell size sc.
            Interpolation (vs nearest-cell blocks) matters twice over:
            step edges pixel-lock the stereo SAD parabola fit (measured
            0.30 px median disparity error -> ~3-8 % depth error on the
            map points), and block lattices are self-similar at the
            matcher's search-window scale, so a drifted motion prediction
            finds a COHERENT set of one-blob-off associations that form a
            second chi2 minimum at the drifted pose (measured: a
            converged local minimum 18 mm from GT that the whole matched
            set votes for).  C1-smooth noise keeps gradients finite for
            subpixel fits and makes neighbouring blobs' BRIEF patches
            share context, breaking the alias ties."""
            # f64 divide, f32 everything after the floor split: the cell
            # fraction needs f32 precision only (texture, not geometry),
            # and halving the memory traffic ~doubles render throughput
            gx, gz = xs / sc, zs / sc
            xf = np.floor(gx)
            zf = np.floor(gz)
            tx = (gx - xf).astype(np.float32)
            tz = (gz - zf).astype(np.float32)
            xi = xf.astype(np.int64).astype(np.uint32)
            zi = zf.astype(np.int64).astype(np.uint32)
            tx = tx * tx * (3 - 2 * tx)
            tz = tz * tz * (3 - 2 * tz)
            one = np.uint32(1)
            n00 = hashed(xi, zi, s_off)
            n10 = hashed(xi + one, zi, s_off)
            n01 = hashed(xi, zi + one, s_off)
            n11 = hashed(xi + one, zi + one, s_off)
            return ((n00 * (1 - tx) + n10 * tx) * (1 - tz) +
                    (n01 * (1 - tx) + n11 * tx) * tz)

        out = np.zeros_like(x, dtype=np.float64)
        # mip-correct sharp blocks.  The base must be FINE (mm-scale): with
        # a coarse base a close-up surface renders as ~60 px flat blocks —
        # featureless interiors plus aperture-problem edges that alias at
        # exactly the matcher's window scale.  With mip selection the
        # projected block size stays ~2.5-5x the pixel footprint at every
        # distance.
        base = 0.008
        # VIEWPOINT-STABLE band-limited octave sum.  Earlier versions
        # mip-SELECTED a single hashed-block octave by pixel footprint —
        # but each octave is an INDEPENDENT random field, so whenever a
        # surface point's footprint crossed an octave boundary its texture
        # was replaced by uncorrelated noise (real downsampled texture is
        # the local AVERAGE of the fine texture, never fresh noise).
        # Measured effect: ~80% of the matched point set churned EVERY
        # frame (descriptors Hamming-stale within ~5 frames), per-frame BA
        # dragged point positions ~1 cm/frame toward the morphing corner
        # consensus, and tracking collapsed at ~12 frames in every world,
        # even with an oracle motion prior.  The fix is standard
        # band-limited procedural noise: the texture is ONE fixed function
        # (a sum of block octaves); the footprint only FADES OUT octaves
        # finer than it can resolve (they box-average to a constant
        # anyway).  Appearance under viewpoint change is then a slowly
        # band-limited version of the same pattern — descriptors stay
        # correlated for the lifetime of a map point.
        if footprint is None:
            kf = np.zeros_like(x, dtype=np.float32)
        else:
            kf = np.log2(np.maximum(2.0 * footprint / base, 1.0)) \
                .astype(np.float32)
        wsum = np.zeros_like(x, dtype=np.float32)
        acc = np.zeros_like(x, dtype=np.float32)
        for k in range(8):
            # octave k fully visible when footprint << its block size,
            # fading smoothly to 0 as the footprint approaches it
            w = np.clip(k + 1.0 - kf, 0.0, 1.0).astype(np.float32)
            live = w > 0
            n_live = int(np.count_nonzero(live))
            if n_live == 0:
                continue
            sc = base * (2.0 ** k)
            # geometric amplitude decay toward coarse octaves: after
            # normalization the finest VISIBLE octave always carries ~40%
            # of the contrast, at every viewing distance (self-similar,
            # like real 1/f surface detail) — an equal-amplitude sum would
            # wash close-up texture out to ~1/8 contrast per octave
            amp = np.float32(0.6 ** k)
            if n_live < 0.6 * live.size:
                # masked evaluation: fine octaves are invisible (w == 0)
                # on distant surfaces — skip the 4 hashes + lerp there
                # (the far wall/ground dominate pixel count, so this cuts
                # most of the per-frame texture cost)
                vals = vnoise(x[live], z[live], sc, 9 + 16 * k)
                wl = w[live]
                acc[live] += wl * amp * vals
                wsum[live] += wl * amp
            else:
                acc += w * amp * vnoise(x, z, sc, 9 + 16 * k)
                wsum += w * amp
        out += 0.75 * acc / np.maximum(wsum, np.float32(1e-9))
        # smooth low-frequency octave for shading variety
        out += 0.25 * vnoise(x, z, 2.0, 0)
        return out

    def _human_segments(self, Rcw, tcw, t: float):
        """Projected limb segments of every visible human at time t:
        [(u1, v1, u2, v2, z_mean, thickness_px, seed)] in level-0 coords."""
        segs = []
        for hu in self.humans:
            joints = hu.joints_at(t)
            u, v, z = self._project(Rcw, tcw, joints)
            if (z < 0.5).any():
                continue
            for s in range(N_PARTS):
                a, b = int(BODY1[s]), int(BODY2[s])
                thick = self.cam.fx * 0.06 / max(float(z[a]), 0.5)
                segs.append((u[a], v[a], u[b], v[b],
                             0.5 * (z[a] + z[b]), thick,
                             137 + 31 * s + 97 * hu.track_id))
        return segs

    def _render_view(self, Rcw, tcw, ss: int = 2, return_depth: bool = False,
                     human_segments=None):
        """Render with ss x supersampling + box downsample (anti-aliasing:
        aliased edges decorrelate the stereo views at sub-pixel disparities
        and poison descriptor matching).  return_depth also returns the
        camera-frame z-buffer (ground-truth depth map)."""
        h, w = self.cam.height * ss, self.cam.width * ss
        fx, fy = self.cam.fx * ss, self.cam.fy * ss
        cx, cy = self.cam.cx * ss, self.cam.cy * ss
        # camera centre and rays in world frame.  The camera-frame ray grid
        # and its per-pixel length depend only on (intrinsics, ss) — cache
        # them across frames (they were ~25% of render cost recomputed
        # identically every view)
        Rwc = Rcw.T
        ow = -Rwc @ tcw
        cache_key = (h, w, fx, fy, cx, cy)
        cached = getattr(self, "_ray_cache", None)
        if cached is None or cached[0] != cache_key:
            vv, uu = np.mgrid[0:h, 0:w]
            d_cam = np.stack([(uu - cx) / fx,
                              (vv - cy) / fy,
                              np.ones_like(uu, np.float64)], axis=-1)
            self._ray_cache = (cache_key, d_cam,
                               np.linalg.norm(d_cam, axis=-1))
        _, d_cam, d_len_cached = self._ray_cache
        d_w = d_cam @ Rwc.T                                   # [h, w, 3]

        img = np.full((h, w), 90.0)
        # textured ground plane (y = +1.6, below camera) and far wall — dense
        # stable texture with true parallax for the static feature pipeline;
        # nearest intersection wins
        dg = d_w[..., 1]
        t_ground = np.where(np.abs(dg) > 1e-6, (1.6 - ow[1]) / np.where(np.abs(dg) > 1e-6, dg, 1.0), np.inf)
        t_ground = np.where(t_ground > 0.05, t_ground, np.inf)
        dz = d_w[..., 2]
        t_wall = np.where(np.abs(dz) > 1e-6, (42.0 - ow[2]) / np.where(np.abs(dz) > 1e-6, dz, 1.0), np.inf)
        t_wall = np.where(t_wall > 0.05, t_wall, np.inf)
        tpar = np.minimum(t_ground, t_wall)
        is_ground = t_ground <= t_wall
        valid = np.isfinite(tpar)
        tc = np.where(valid, tpar, 1.0)
        px = ow[0] + tc * d_w[..., 0]
        py = ow[1] + tc * d_w[..., 1]
        pz = ow[2] + tc * d_w[..., 2]
        # mip footprint in FINAL-resolution pixels (x ss), stretched by
        # 1/cos(incidence): the box downsample only averages — texture
        # content must already be band-limited at the output scale, and on
        # OBLIQUE surfaces the along-surface footprint grows by the slant
        # factor (unaccounted, a wall seen near-edge-on renders ~1-px
        # aliased noise — systematic stereo bias on slanted views)
        d_len = d_len_cached
        n_comp = np.where(is_ground, np.abs(dg), np.abs(dz))
        slant = np.clip(d_len / np.maximum(n_comp, 1e-6), 1.0, 20.0)
        footprint = tc * d_len / fx * ss * slant
        # masked evaluation: each pixel belongs to exactly one surface, so
        # evaluating the (8-octave) noise only at that surface's pixels cuts
        # total texture cost from O(pixels x surfaces) to O(pixels) — the
        # render was the dominant e2e-test cost (measured 2.9 s/frame)
        sel_g = valid & is_ground
        sel_w = valid & ~is_ground
        if sel_g.any():
            img[sel_g] = 40 + 180 * self._value_noise(
                px[sel_g], pz[sel_g], seed=7, footprint=footprint[sel_g])
        if sel_w.any():
            img[sel_w] = 40 + 180 * self._value_noise(
                px[sel_w], py[sel_w], seed=11, footprint=footprint[sel_w])
        # zbuf stores the ray parameter t, which IS the camera depth
        # (d_cam has z-component 1); comparing t*d_w_z instead would flip
        # the z-test wherever the world ray points to -z (backward views)
        zbuf = np.where(valid, tc, np.inf)

        # textured plane patches (walls, billboards, pillar faces), one
        # z-buffered pass over the unified list {p : p.nvec = d0} with
        # in-plane axes (tvec, ey).  Each patch's 4 corners are projected
        # first and computation is cropped to the pixel bbox; all per-pixel
        # work past the z-test runs on the surviving pixels only (near-to-
        # far order makes that set small for occluded surfaces) — full-
        # image passes per surface made rendering the dominant host cost.
        d_norm = None
        for (nvec, d0, tvec, a0, y0, bw, bh, seed) in self._surfaces:
            corners = [nvec * d0 + tvec * (a0 + sa * bw / 2) +
                       np.array([0.0, y0 + sy * bh / 2, 0.0])
                       for sa in (-1, 1) for sy in (-1, 1)]
            cc = (Rcw @ np.stack(corners).T).T + tcw
            zc = cc[:, 2]
            if (zc < 0.05).all():
                continue
            if (zc < 0.05).any():
                u0, u1, v0, v1 = 0, w, 0, h      # crosses image plane: full
            else:
                uc = fx * cc[:, 0] / zc + cx
                vc = fy * cc[:, 1] / zc + cy
                u0 = max(0, int(np.floor(uc.min())) - 1)
                u1 = min(w, int(np.ceil(uc.max())) + 2)
                v0 = max(0, int(np.floor(vc.min())) - 1)
                v1 = min(h, int(np.ceil(vc.max())) + 2)
                if u0 >= u1 or v0 >= v1:
                    continue
            dw_c = d_w[v0:v1, u0:u1]
            dn = dw_c @ nvec
            # rays parallel to the plane divide to +-inf/NaN and fail the
            # z-test comparisons below, which is the correct exclusion
            with np.errstate(divide="ignore", invalid="ignore"):
                tb = (d0 - float(ow @ nvec)) / dn
            okb = (tb > 0.05) & (tb < zbuf[v0:v1, u0:u1] - 1e-6)
            iy0, ix0 = np.nonzero(okb)
            if iy0.size == 0:
                continue
            tb_i = tb[iy0, ix0]
            ba = float(ow @ tvec) + tb_i * (dw_c[iy0, ix0] @ tvec)
            by = ow[1] + tb_i * dw_c[iy0, ix0, 1]
            keep = (np.abs(ba - a0) <= bw / 2) & (np.abs(by - y0) <= bh / 2)
            if not keep.any():
                continue
            iy, ix = iy0[keep], ix0[keep]
            tb_i = tb_i[keep]
            if d_norm is None:
                d_norm = d_len_cached
            dl = d_norm[v0:v1, u0:u1][iy, ix]
            dn_i = dn[iy, ix]
            slant_b = np.clip(dl / np.maximum(np.abs(dn_i), 1e-6), 1.0, 20.0)
            fp = tb_i * dl / fx * ss * slant_b
            tex = self._value_noise(ba[keep], by[keep], seed=seed,
                                    footprint=fp)
            img[v0:v1, u0:u1][iy, ix] = 40 + 180 * tex
            zbuf[v0:v1, u0:u1][iy, ix] = tb_i
        img = np.clip(img, 0, 255)
        # project with the supersampled intrinsics (u_ss = ss * u): drawing
        # level-0 coords on the ss canvas would place dots at half position,
        # putting them in a geometrically inconsistent world vs the raycast
        # surfaces (2x-wrong disparity/parallax)
        u, v, z = self._project(Rcw, tcw, self.points)
        u, v = u * ss, v * ss
        r_px = fx * self.phys_radius / np.maximum(z, 1e-3)
        ok = (z > 0.3) & (u >= -8) & (u < w + 8) & (v >= -8) & (v < h + 8) & (r_px >= 0.8)
        us, vs, zs = self._project(Rcw, tcw, self.points + self.sat_offset)
        us, vs = us * ss, vs * ss
        order = np.argsort(-z[ok])       # far first so near dots overwrite
        idx = np.nonzero(ok)[0][order]
        for i in idx:
            # z-test against the surface buffer: a dot behind a wall /
            # billboard / pillar face must not render through it (a
            # stereo-consistent but geometrically-impossible landmark)
            cu = int(np.clip(round(u[i]), 0, w - 1))
            cvv = int(np.clip(round(v[i]), 0, h - 1))
            if z[i] - 0.05 > zbuf[cvv, cu]:
                continue
            r = max(1, int(round(min(r_px[i], 8.0))))
            fill_circle(img, (int(round(u[i])), int(round(v[i]))), r,
                        float(self.intensity[i]))
            fill_circle(img, (int(round(us[i])), int(round(vs[i]))),
                        max(1, r // 2), float(self.sat_intensity[i]))
            if return_depth:
                fill_circle(zbuf, (int(round(u[i])), int(round(v[i]))), r,
                            float(z[i]))
                fill_circle(zbuf, (int(round(us[i])), int(round(vs[i]))),
                            max(1, r // 2), float(zs[i]))
        # dynamic humans: textured limb capsules drawn over everything nearer
        # than the current zbuf (they occlude and carry trackable texture, so
        # an unmasked static pipeline picks up moving features — the dynamic-
        # scene failure mode AirDOS exists to fix)
        if human_segments:
            for (u1, v1, u2, v2, zseg, thick, seed) in human_segments:
                p1 = (int(round(u1 * ss)), int(round(v1 * ss)))
                p2 = (int(round(u2 * ss)), int(round(v2 * ss)))
                mseg = np.zeros(img.shape, np.uint8)
                draw_line(mseg, p1, p2, 1, max(1, int(round(thick * ss))))
                sel = (mseg > 0) & (zseg < zbuf)
                if not sel.any():
                    continue
                # texture in the limb's own coordinates (fraction along the
                # bone x signed offset across it): identical in both stereo
                # views and stable while the limb moves, so the unmasked
                # static pipeline tracks these features frame to frame —
                # the dynamic-scene poison AirDOS exists to handle
                ys_, xs_ = np.nonzero(sel)
                dx, dy_ = (u2 - u1) * ss, (v2 - v1) * ss
                L2 = max(dx * dx + dy_ * dy_, 1e-6)
                along = ((xs_ - p1[0]) * dx + (ys_ - p1[1]) * dy_) / L2
                across = ((xs_ - p1[0]) * -dy_ + (ys_ - p1[1]) * dx) / np.sqrt(L2)
                tex = self._value_noise(along * 0.5, across * 0.01 + 0.02,
                                        seed=seed)
                img[ys_, xs_] = 50 + 160 * tex
                zbuf = np.where(sel, zseg, zbuf)

        out = img.astype(np.float32)
        if ss > 1:
            out = out.reshape(self.cam.height, ss, self.cam.width, ss).mean(axis=(1, 3))
        if return_depth:
            zb = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
            if ss > 1:
                # min-pool: a pixel's depth is its nearest surface
                zb = zb.reshape(self.cam.height, ss, self.cam.width, ss)
                zb = np.where(zb <= 0, np.inf, zb).min(axis=(1, 3))
                zb = np.where(np.isfinite(zb), zb, 0.0).astype(np.float32)
            return out, zb
        return out

    def camera_pose_cw(self, Rwc, twc):
        Rcw = Rwc.T
        tcw = -Rcw @ twc
        return Rcw, tcw

    def frame(self, i: int, Rwc: np.ndarray, twc: np.ndarray,
              timestamp: float, noise_px: float = 0.3,
              with_humans: bool = True,
              with_depth: bool = False) -> FrameData:
        """Render a stereo FrameData at the given camera-to-world pose.
        with_depth also fills FrameData.depth with the left camera's
        ground-truth z-buffer (for the RGB-D / IsGroundTruthDepth path)."""
        Rcw, tcw = self.camera_pose_cw(Rwc, twc)
        b = self.cam.baseline
        tcw_r = tcw - np.array([b, 0, 0])   # right cam: +b along camera x
        segsL = segsR = None
        if with_humans and self.humans:
            segsL = self._human_segments(Rcw, tcw, timestamp)
            segsR = self._human_segments(Rcw, tcw_r, timestamp)
        depthL = None
        if with_depth:
            imL, depthL = self._render_view(Rcw, tcw, return_depth=True,
                                            human_segments=segsL)
        else:
            imL = self._render_view(Rcw, tcw, human_segments=segsL)
        imR = self._render_view(Rcw, tcw_r, human_segments=segsR)

        humans_l = humans_r = tids = None
        seg_l = seg_r = None
        if with_humans and self.humans:
            h, w = self.cam.height, self.cam.width
            hl, hr, ids = [], [], []
            seg_l = np.zeros((h, w), np.uint8)
            seg_r = np.zeros((h, w), np.uint8)
            for hu in self.humans:
                joints = hu.joints_at(timestamp)
                uL, vL, zL = self._project(Rcw, tcw, joints)
                uR, vR, zR = self._project(Rcw, tcw_r, joints)
                if (zL <= 0.3).any() or not ((uL > 0) & (uL < w) & (vL > 0) & (vL < h)).mean() > 0.6:
                    continue
                nz = np.random.default_rng(i * 1000 + hu.track_id)
                obs_l = np.stack([uL + nz.normal(0, noise_px, N_JOINTS),
                                  vL + nz.normal(0, noise_px, N_JOINTS),
                                  np.full(N_JOINTS, 0.9)], axis=1)
                obs_r = np.stack([uR + nz.normal(0, noise_px, N_JOINTS),
                                  vR + nz.normal(0, noise_px, N_JOINTS),
                                  np.full(N_JOINTS, 0.9)], axis=1)
                hl.append(obs_l)
                hr.append(obs_r)
                ids.append(hu.track_id)
                # silhouette-shaped seg mask: dilated limb capsules (a full
                # bounding box blacks out far more static background than a
                # real instance-segmentation mask would)
                for seg_im, uu, vv, zz in ((seg_l, uL, vL, zL),
                                           (seg_r, uR, vR, zR)):
                    for s in range(N_PARTS):
                        a, b = int(BODY1[s]), int(BODY2[s])
                        th_px = int(max(3, self.cam.fx * 0.12 /
                                        max(float(zz[a]), 0.5)))
                        draw_line(seg_im, (int(uu[a]), int(vv[a])),
                                  (int(uu[b]), int(vv[b])), 255, th_px)
            if hl:
                humans_l = np.asarray(hl)
                humans_r = np.asarray(hr)
                tids = np.asarray(ids)
            else:
                humans_l = np.zeros((0, 18, 3))
                humans_r = np.zeros((0, 18, 3))
                tids = np.zeros((0,), np.int64)

        return FrameData(timestamp=timestamp, index=i,
                         image_left=imL, image_right=imR,
                         seg_left=seg_l, seg_right=seg_r,
                         depth=depthL,
                         humans_left=humans_l, humans_right=humans_r,
                         track_ids=tids)

    def sequence(self, n_frames: int, dt: float = 0.1,
                 speed: float = 0.5, yaw_rate: float = 0.02, **kw):
        """Yield (FrameData, Rwc, twc) over a default trajectory."""
        Rwc, twc = self.trajectory(n_frames, dt, speed=speed,
                                   yaw_rate=yaw_rate)
        for i in range(n_frames):
            yield self.frame(i, Rwc[i], twc[i], i * dt, **kw), Rwc[i], twc[i]
