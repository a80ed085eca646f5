"""System facade — the public API (reference: src/System.cc, System.h:75-149).

Usage mirrors the reference:

    cfg = SlamConfig.from_yaml("tartanair.yaml")
    slam = System(cfg)
    for data in sequence:                 # io.datasets.FrameData
        slam.track_stereo_human(data)     # or track_stereo(...)
    slam.before_end("map_dump_dir")       # optional SaveMap metadata dump
    slam.shutdown()
    slam.save_trajectory_tum("traj.txt")
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from airdos_tpu.config import SlamConfig
from airdos_tpu.io.datasets import FrameData
from airdos_tpu.io.tum import write_trajectory_kitti, write_trajectory_tum
from airdos_tpu.slam.frame import FrontEnd
from airdos_tpu.slam.local_mapping import LocalMapper
from airdos_tpu.slam.map import SlamMap
from airdos_tpu.slam.tracking import Tracking, TrackState


class System:
    def __init__(self, config: SlamConfig, use_viewer: bool = False):
        self.config = config
        self.map = SlamMap()
        self.frontend = FrontEnd(config)
        self.local_mapper = LocalMapper(config, self.map)
        self.tracking = Tracking(config, self.frontend, self.map,
                                 self.local_mapper)
        from airdos_tpu.slam.ba_driver import (Fuser, GlobalBA, HumanLocalBA,
                                               StaticLocalBA, Triangulator)
        ext = self.frontend.extractor
        self.static_ba = StaticLocalBA(config, self.map, ext,
                                       map_lock=self.tracking.map_lock)
        self.global_ba = GlobalBA(config, self.map, ext)
        self.local_mapper.triangulator = Triangulator(
            config, self.map, ext, self.local_mapper,
            map_lock=self.tracking.map_lock)
        self.local_mapper.fuser = Fuser(config, self.map, ext,
                                        map_lock=self.tracking.map_lock)
        self.human_ba = HumanLocalBA(config, self.map, ext,
                                     map_lock=self.tracking.map_lock) \
            if config.human.ok else None
        self._frame_count = 0
        self._last_human_ba_frame = 0
        # online mode: mapping runs concurrently with tracking, like the
        # reference's LocalMapping thread (offline mode stays synchronous
        # and deterministic, the paper configuration)
        import threading
        self._map_lock = self.tracking.map_lock
        self._map_queue = None
        self._map_thread = None
        if not config.system.is_offline:
            import queue
            self._map_queue = queue.Queue()
            self._map_thread = threading.Thread(
                target=self._mapping_worker, daemon=True)
            self._map_thread.start()
            # keyframe-insertion gating (reference AcceptKeyFrames /
            # KeyframesInQueue, Tracking.cc:1101-1121): idle = no queued
            # AND no in-flight keyframe (unfinished_tasks counts both)
            self.tracking.mapping_idle_fn = \
                lambda: self._map_queue.unfinished_tasks == 0
            self.tracking.mapping_queue_len_fn = self._map_queue.qsize
            # tracking-priority device scheduling: mapping-side workers
            # defer their dispatches while the tracking thread is inside
            # its per-frame device window (utils/gate.py)
            from airdos_tpu.utils.gate import TrackingGate
            gate = TrackingGate()
            self.tracking.device_gate = gate
            for drv in (self.static_ba, self.global_ba,
                        self.local_mapper.triangulator,
                        self.local_mapper.fuser, self.human_ba):
                if drv is not None:
                    drv.gate = gate
        # place recognition: load a vocabulary now, or train a scene
        # vocabulary lazily from the first keyframe's descriptors
        self.vocabulary = None
        self.keyframe_db = None
        self.loop_closer = None
        if config.vocabulary_path:
            # suffix dispatch like the reference (System.cc:56-67 selects
            # text vs binary loader by has_suffix(".txt"/".bin"))
            from airdos_tpu.bow.vocabulary import (Vocabulary,
                                                   load_dbow2_binary,
                                                   load_dbow2_text)
            p = str(config.vocabulary_path)
            self.vocabulary = (Vocabulary.load_npz(p) if p.endswith(".npz")
                               else load_dbow2_binary(p) if p.endswith(".bin")
                               else load_dbow2_text(p))
            self._init_place_recognition()
        self.track_times: List[float] = []
        self.viewer = None
        if use_viewer:
            from airdos_tpu.viz.viewer import Viewer
            self.viewer = Viewer(self.map, self.tracking)
        # observability: per-stage host profiler + structured event log
        # (AIRDOS_TRACE_DIR additionally enables jax.profiler device traces)
        import os
        from airdos_tpu.utils.obs import EventLog, Profiler
        self.profiler = Profiler(trace_dir=os.environ.get("AIRDOS_TRACE_DIR"))
        self.events = EventLog(path=os.environ.get("AIRDOS_EVENT_LOG"))
        from airdos_tpu.utils import obs as _obs
        _obs._global_log = self.events     # subsystem emissions land here
        self.static_ba.profiler = self.profiler
        self.tracking.profiler = self.profiler

    # ----------------------------------------------------------------- api
    def track_stereo(self, data: FrameData):
        """TrackStereo — static-only stereo tracking."""
        return self._track(data)

    def track_stereo_human(self, data: FrameData):
        """TrackStereoHuman — stereo + dynamic-human pipeline."""
        return self._track(data)

    def drain_mapping(self, timeout: float = 30.0) -> bool:
        """Block until the mapping worker has fully processed every queued
        keyframe (online mode; no-op offline).  Returns False on timeout.

        Use this to pace a producer that can outrun real time — e.g. a
        dataset feeder with no frame-rate cap, or a deterministic test:
        the reference's equivalent is the stereo_human.cc main loop
        sleeping to the dataset timestamp (Examples/Stereo/
        stereo_human.cc:135-146), which implicitly lets LocalMapping
        drain between frames."""
        if self._map_queue is None:
            return True
        deadline = time.perf_counter() + timeout
        while self._map_queue.unfinished_tasks:
            if time.perf_counter() > deadline:
                return False
            time.sleep(0.002)
        return True

    def activate_localization_mode(self):
        """Track against the frozen map; local mapping is paused and no
        keyframes are inserted (reference System::ActivateLocalizationMode,
        System.cc:288-296)."""
        with self._map_lock:
            self.tracking.only_tracking = True

    def deactivate_localization_mode(self):
        with self._map_lock:
            self.tracking.only_tracking = False

    def reset(self):
        """User-triggered full reset (reference System::Reset handshake,
        System.cc:308-311, serviced by Tracking::Reset,
        Tracking.cc:1656-1705: stop background optimization, clear the BoW
        database and the map, restart tracking from scratch)."""
        self.global_ba.interrupt(wait=True)        # outside the map lock
        if self.human_ba is not None:
            self.human_ba.join()      # a write-back into a cleared map
        with self._map_lock:
            if self._map_queue is not None:
                while not self._map_queue.empty():
                    self._map_queue.get_nowait()
                    self._map_queue.task_done()
            self.tracking._reset()
            if self.keyframe_db is not None:
                self.keyframe_db.clear()
            if self.loop_closer is not None:
                self.loop_closer._consistent_groups = []
                self.loop_closer._last_loop_kf = -1e9
            self._last_human_ba_frame = self._frame_count
        self.events.emit("reset")

    def _init_place_recognition(self):
        from airdos_tpu.slam.keyframe_db import KeyFrameDatabase
        from airdos_tpu.slam.loop_closing import LoopCloser
        self.keyframe_db = KeyFrameDatabase(self.vocabulary, self.map)
        self.tracking.keyframe_db = self.keyframe_db
        self.local_mapper.keyframe_db = self.keyframe_db
        self.loop_closer = LoopCloser(self.config, self.map, self.keyframe_db,
                                      self.frontend.extractor,
                                      fuser=self.local_mapper.fuser,
                                      global_ba=self.global_ba,
                                      map_lock=self._map_lock)
        self.loop_closer.gate = self.tracking.device_gate
        for kf in self.map.kfs.values():
            if not kf.bad:
                self.keyframe_db.add(kf)

    def _maybe_train_vocabulary(self):
        """Train a small scene vocabulary from the first keyframes'
        descriptors (the reference instead loads the 145 MB ORBvoc.txt;
        config.vocabulary_path accepts that format too)."""
        if self.vocabulary is not None or self.map.n_keyframes() < 1:
            return
        from airdos_tpu.bow.vocabulary import train_vocabulary
        descs = []
        for kf in self.map.kfs.values():
            d = kf.desc32[kf.valid]
            descs.append(d.view(np.uint8).reshape(len(d), 32))
        train = np.concatenate(descs, axis=0)
        if len(train) < 200:
            return
        self.vocabulary = train_vocabulary(train, k=8, depth=3)
        self._init_place_recognition()

    def _mapping_pipeline(self, prev_kf):
        """The per-keyframe local-mapping steps (reference: LocalMapping::Run
        body).  Runs inline in offline mode, or in the mapping worker thread
        in online mode (System.IsOffline=0), mirroring the reference's
        Tracking || LocalMapping threading (System.cc:87-96)."""
        from airdos_tpu.utils.obs import span
        lm = self.local_mapper
        # Lock granularity mirrors the reference: LocalMapping holds the
        # map mutex per step, never across a whole keyframe's pipeline
        # (Map::mMutexMapUpdate is taken inside each Optimizer/mapping
        # routine), so the tracking thread's short map sections interleave
        # between mapping stages in online mode.
        with self._map_lock:
            with span(self.profiler, "map.cull_points"):
                lm.cull_map_points(prev_kf.id)
        # Triangulator / Fuser / StaticLocalBA take the lock themselves
        # for graph assembly + write-back and RELEASE it during their
        # device dispatches, so the tracking thread only ever waits on
        # short host-side map sections.
        with span(self.profiler, "map.triangulate"):
            lm.create_new_points(prev_kf)
        with span(self.profiler, "map.fuse"):
            lm.fuse_neighbors(prev_kf)
        # The reference runs ONE local BA (static or human-trajectory,
        # by IsStaticOnly) every mMaxFrames (Tracking.cc:705-717).  We
        # run the static local BA per keyframe in BOTH modes — per-KF
        # refinement is what lifts this rebuild past the reference's
        # accuracy — and the human pipeline keeps its human-trajectory
        # BA on the reference cadence on top.  The BA takes the lock
        # itself for assembly and write-back and releases it during the
        # device solve (reference LocalBundleAdjustment locks the map
        # only for its recovery phase, Optimizer.cc:657-659).
        if self.static_ba is not None and self.map.n_keyframes() > 2:
            with span(self.profiler, "map.static_ba"):
                self.static_ba(prev_kf)
        with self._map_lock:
            with span(self.profiler, "map.cull_kfs"):
                lm.cull_keyframes(prev_kf)
            with span(self.profiler, "map.vocab"):
                self._maybe_train_vocabulary()
            kf_alive = self.keyframe_db is not None and not prev_kf.bad
        # loop closing runs OUTSIDE the map lock: detection + Sim3 lock
        # fine-grained around host map reads and release across device
        # dispatches; only correct() holds the lock throughout (the
        # reference's dedicated LoopClosing thread gives it the same
        # non-blocking property, System.cc:173-174)
        if kf_alive:
            if self.loop_closer is not None and \
                    self.config.loop_closing_active:
                with span(self.profiler, "map.loop_closing"):
                    self.loop_closer.process(prev_kf)
            else:
                with self._map_lock:
                    self.keyframe_db.add(prev_kf)

    def _mapping_worker(self):
        while True:
            kf = self._map_queue.get()
            if kf is None:
                self._map_queue.task_done()
                return
            try:
                self._mapping_pipeline(kf)
            except Exception:
                import traceback
                traceback.print_exc()
            finally:
                # marks the keyframe fully processed — until then the
                # tracker sees mapping as busy (AcceptKeyFrames == false)
                self._map_queue.task_done()

    def _to_gray(self, img: np.ndarray) -> np.ndarray:
        """Color -> grayscale honoring Camera.RGB channel order (reference
        Tracking.cc:247-272 cvtColor CV_RGB2GRAY / CV_BGR2GRAY)."""
        if img.ndim == 2:
            return img
        w = np.asarray([0.299, 0.587, 0.114], np.float32)
        if not self.config.camera.rgb:      # BGR input
            w = w[::-1]
        return (img[..., :3].astype(np.float32) @ w)

    def prefetch(self, data: FrameData):
        """Begin the async device upload of a FUTURE frame's images so the
        transfer overlaps the current frame's compute — call
        with frame i+1 before (or while) tracking frame i."""
        if data.image_left.ndim == 3 or data.image_right.ndim == 3:
            import dataclasses as _dc
            data = _dc.replace(data,
                               image_left=self._to_gray(data.image_left),
                               image_right=self._to_gray(data.image_right))
        self.frontend.prefetch(data)

    def _track(self, data: FrameData):
        from airdos_tpu.utils.obs import span
        if data.image_left.ndim == 3 or data.image_right.ndim == 3:
            import dataclasses as _dc
            data = _dc.replace(data,
                               image_left=self._to_gray(data.image_left),
                               image_right=self._to_gray(data.image_right))
        t0 = time.perf_counter()
        with span(self.profiler, "track"):
            frame = self.tracking.track(data)
        prev_kf = self.map.kfs.get(self.tracking.last_kf_id)

        if (self.tracking.state == TrackState.OK and prev_kf is not None
                and not self.tracking.only_tracking
                and prev_kf.frame_id == frame.index):
            if self._map_queue is not None:
                self._map_queue.put(prev_kf)
            else:
                self._mapping_pipeline(prev_kf)

        # human-trajectory local BA every max_frames frames (OffLineTrack,
        # Tracking.cc:705-717)
        if (self.human_ba is not None and self.config.human.ok
                and not self.config.optimizer.is_static_only
                and self.tracking.state == TrackState.OK
                and self._frame_count - self._last_human_ba_frame >=
                self.tracking.max_frames
                and self.map.long_trajectories()):
            if self._map_queue is not None:
                # online: overlap the dense reduced solve with tracking
                # (assembly/write-back lock the map; the solve runs
                # unlocked in its own thread).  A still-running BA skips
                # this cadence tick and retries next frame.
                if self.human_ba.launch(self.tracking.last_kf_id):
                    self._last_human_ba_frame = self._frame_count
            else:
                # offline (paper configuration): synchronous and
                # deterministic, like OffLineTrack (Tracking.cc:705-717)
                with span(self.profiler, "human_ba"):
                    self.human_ba(self.map, self.tracking.last_kf_id)
                self._last_human_ba_frame = self._frame_count

        self._frame_count += 1
        dt = time.perf_counter() - t0
        self.track_times.append(dt)
        self.events.emit("frame", index=data.index,
                         state=self.tracking.state.name,
                         n_inliers=int(self.tracking.n_inliers),
                         n_kfs=self.map.n_keyframes(),
                         n_points=self.map.n_points(),
                         track_s=round(dt, 4))
        if self.viewer is not None:
            self.viewer.update(frame)
        return frame

    # ------------------------------------------------------------- export
    def save_trajectory_tum(self, path: str):
        ts, Rwc, twc = self.tracking.trajectory_tum()
        write_trajectory_tum(path, ts, Rwc, twc)

    def save_keyframe_trajectory_tum(self, path: str):
        kfs = sorted((kf for kf in self.map.kfs.values() if not kf.bad),
                     key=lambda k: k.id)
        ts = [kf.timestamp for kf in kfs]
        Rwc = np.asarray([kf.Rwc for kf in kfs])
        twc = np.asarray([kf.Ow for kf in kfs])
        write_trajectory_tum(path, ts, Rwc, twc)

    def save_trajectory_kitti(self, path: str):
        ts, Rwc, twc = self.tracking.trajectory_tum()
        write_trajectory_kitti(path, Rwc, twc)

    def before_end(self, out_dir: Optional[str] = None):
        """Tracking::SaveMap metadata dump (KF/MP/Match/HMTraj/Motion .txt,
        reference Tracking.cc:1745-1836).  With no explicit directory the
        dump goes to Data.MetaDataPath from the settings YAML (the
        reference passes msDataFolder from that key into SaveMap,
        Tracking.cc:180, System.cc:583-599)."""
        if out_dir is None:
            out_dir = self.config.meta_data_path or None
        if out_dir is None:
            return
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        pt = self.map.points
        with open(out / "KF.txt", "w") as f:
            for kf in sorted(self.map.kfs.values(), key=lambda k: k.id):
                if kf.bad:
                    continue
                q = _rot_to_quat_wxyz(kf.Rwc)
                ow = kf.Ow
                f.write(f"{kf.id} {kf.timestamp:.6f} "
                        f"{ow[0]:.7f} {ow[1]:.7f} {ow[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
        with open(out / "MP.txt", "w") as f:
            for pid in pt.live_ids():
                p = pt.pos[pid]
                f.write(f"{pid} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f}\n")
        with open(out / "Match.txt", "w") as f:
            for pid in pt.live_ids():
                for kf_id, fid in pt.obs[pid].items():
                    kf = self.map.kfs.get(kf_id)
                    if kf is None or kf.bad:
                        continue
                    u, v = kf.xy_un[fid]
                    ur = kf.u_right[fid]
                    isig = 1.0 / (self.frontend.extractor.sigma2[kf.octave[fid]])
                    f.write(f"{pid} {kf_id} {u:.3f} {v:.3f} {ur:.3f} {isig:.5f}\n")
        with open(out / "HMTraj.txt", "w") as f:
            for tid, traj in sorted(self.map.trajectories.items()):
                for i, hp in enumerate(traj.poses):
                    for j in range(hp.joints_w.shape[0]):
                        p = hp.joints_w[j]
                        f.write(f"{tid} {i} {j} {hp.timestamp:.6f} "
                                f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                                f"{int(hp.bad[j])} {int(hp.lost[j])} "
                                f"{int(hp.optimized[j])}\n")
        with open(out / "Motion.txt", "w") as f:
            for tid, traj in sorted(self.map.trajectories.items()):
                R, t = traj.motion_R, traj.motion_t
                row = " ".join(f"{v:.7f}" for v in
                               np.hstack([R, t[:, None]]).reshape(-1))
                f.write(f"{tid} {row}\n")

    def save_map(self, path: str):
        """Checkpoint the full map (the reference declares this TODO)."""
        from airdos_tpu.slam.map import save_map
        with self._map_lock:
            save_map(self.map, path)

    def load_map(self, path: str):
        """Resume from a checkpoint; tracking relocalizes against it."""
        from airdos_tpu.slam.map import load_map
        with self._map_lock:
            m = load_map(path)
            self.map.__dict__.update(m.__dict__)
            self.tracking.state = \
                __import__("airdos_tpu.slam.tracking", fromlist=["TrackState"]).TrackState.LOST
            self.tracking.last_kf_id = max(self.map.kfs) if self.map.kfs else -1

    def shutdown(self):
        if self._map_queue is not None:
            self._map_queue.put(None)
            self._map_thread.join(timeout=30)
        if self.human_ba is not None:
            self.human_ba.join()      # drain any background human BA
        if self.global_ba is not None:
            self.global_ba.join()     # drain any background GBA thread
        if self.viewer is not None:
            self.viewer.close()

    # ------------------------------------------------------------- stats
    def timing_report(self):
        tt = sorted(self.track_times)
        n = len(tt)
        if n == 0:
            return {"median_s": 0.0, "mean_s": 0.0}
        return {"median_s": tt[n // 2], "mean_s": sum(tt) / n}


def _rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as _R
    q = _R.from_matrix(R).as_quat()  # x, y, z, w
    return np.array([q[3], q[0], q[1], q[2]])
