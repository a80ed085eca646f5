"""Offline map/trajectory viewer (reference: Viewer/MapDrawer/FrameDrawer,
Pangolin-based).  This rebuild keeps visualization entirely off the hot
path: state snapshots accumulate cheaply per frame; rendering happens via
matplotlib on demand (save_map_figure) or not at all.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# per-track colormap in the spirit of Map.h:59-86
_TRACK_COLORS = np.array([
    [0.85, 0.32, 0.31], [0.13, 0.59, 0.95], [0.30, 0.69, 0.31],
    [0.96, 0.70, 0.10], [0.61, 0.35, 0.71], [0.00, 0.74, 0.83],
    [0.91, 0.12, 0.39], [0.55, 0.76, 0.29],
])


class Viewer:
    def __init__(self, slam_map, tracking, keep_overlays: bool = False):
        self.map = slam_map
        self.tracking = tracking
        self.poses = []          # camera centres over time
        self.frame_overlays = []
        self.keep_overlays = keep_overlays
        self.gt_poses = None     # optional [N, 3] GT camera centres
        self._live_every = 0
        self._live_fig = self._live_ax = None

    def update(self, frame):
        self.poses.append(frame.Ow.copy())
        if self.keep_overlays:
            from airdos_tpu.viz.frame_drawer import draw_frame
            self.frame_overlays.append(draw_frame(
                frame, self.tracking.state.name,
                self.map.n_keyframes(), self.map.n_points()))
        if self._live_every and len(self.poses) % self._live_every == 0:
            self._refresh_live()

    # ------------------------------------------------------------- live
    def start_live(self, every: int = 5):
        """Interactive map view refreshed every N frames (reference:
        Viewer::Run's Pangolin loop; here matplotlib-interactive, entirely
        best-effort — headless environments quietly no-op)."""
        try:
            import matplotlib
            import matplotlib.pyplot as plt
            plt.ion()
            self._live_fig, self._live_ax = plt.subplots(figsize=(6, 6))
            self._live_every = every
        except Exception:
            self._live_every = 0

    def _refresh_live(self):
        import matplotlib.pyplot as plt
        ax = self._live_ax
        ax.clear()
        pt = self.map.points
        live = pt.live_ids()
        if len(live):
            ax.scatter(pt.pos[live, 0], pt.pos[live, 2], s=1, c="#999999")
        P = np.asarray(self.poses)
        ax.plot(P[:, 0], P[:, 2], "-", c="#1565c0", lw=1.5)
        ax.set_aspect("equal")
        self._live_fig.canvas.draw_idle()
        plt.pause(0.001)

    def set_ground_truth(self, centers):
        """GT camera trace for rendering (MapDrawer::DrawCameraGT,
        reference MapDrawer.cc:511-520)."""
        self.gt_poses = np.asarray(centers)

    def close(self):
        pass

    # ---------------------------------------------------------------- io
    def save_map_figure(self, path: str, show_humans: bool = True,
                        optimized_only: bool = False,
                        show_covisibility: bool = True,
                        show_motion: bool = True):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from airdos_tpu.slam.map import BODY1, BODY2

        fig, ax = plt.subplots(figsize=(8, 8))
        pt = self.map.points
        live = pt.live_ids()
        if len(live):
            ax.scatter(pt.pos[live, 0], pt.pos[live, 2], s=1, c="#999999",
                       label="map points")
        if self.poses:
            P = np.asarray(self.poses)
            ax.plot(P[:, 0], P[:, 2], "-", c="#1565c0", lw=1.5, label="camera")
        live_kfs = [kf for kf in self.map.kfs.values() if not kf.bad] \
            if self.map.kfs else []
        if live_kfs:
            kf_centers = np.asarray([kf.Ow for kf in live_kfs])
            ax.scatter(kf_centers[:, 0], kf_centers[:, 2], s=12, c="#0d47a1",
                       marker="s", label="keyframes")
            if show_covisibility:
                # covisibility graph (>=100 shared points) + spanning tree,
                # MapDrawer::DrawKeyFrames (reference MapDrawer.cc:96-191)
                ctr = {kf.id: kf.Ow for kf in live_kfs}
                segs = []
                for kf in live_kfs:
                    for nid, wgt in kf.covis.items():
                        if wgt >= 100 and nid in ctr and nid > kf.id:
                            segs.append((ctr[kf.id], ctr[nid]))
                    if kf.parent is not None and kf.parent in ctr:
                        segs.append((ctr[kf.id], ctr[kf.parent]))
                    for lid in kf.loop_edges:
                        if lid in ctr and lid > kf.id:
                            segs.append((ctr[kf.id], ctr[lid]))
                for a, b in segs:
                    ax.plot([a[0], b[0]], [a[2], b[2]], "-", c="#90caf9",
                            lw=0.4, zorder=0)
        if self.gt_poses is not None and len(self.gt_poses):
            ax.plot(self.gt_poses[:, 0], self.gt_poses[:, 2], "--",
                    c="#2e7d32", lw=1.0, label="GT camera")
        if show_humans:
            for tid, traj in self.map.trajectories.items():
                if optimized_only and not traj.optimized:
                    continue
                col = _TRACK_COLORS[tid % len(_TRACK_COLORS)]
                centers = np.asarray([hp.joints_w[1] for hp in traj.poses])
                ax.plot(centers[:, 0], centers[:, 2], "-o", ms=2, lw=1,
                        color=col, label=f"human {tid}")
                if show_motion and traj.optimized and len(centers):
                    # constant-velocity motion arrow per trajectory
                    # (MapDrawer::DrawMotion, reference MapDrawer.cc:445-461)
                    v = traj.motion_t
                    c0 = centers[-1]
                    ax.annotate("", xy=(c0[0] + v[0], c0[2] + v[2]),
                                xytext=(c0[0], c0[2]),
                                arrowprops=dict(arrowstyle="->", color=col,
                                                lw=1.5))
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.set_aspect("equal")
        ax.legend(loc="best", fontsize=8)
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
