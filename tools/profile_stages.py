"""Per-stage breakdown of the tracking + mapping pipelines (the
reference's only analogue is the per-frame ms printout,
Examples/Stereo/stereo_human.cc:148-150).

Runs the static pipeline on a clean world and the flagship human pipeline
on the crowd world (the bench scenes), then prints the Profiler's
median/mean per stage:

  track            fused front-end + matching + pose LM (one dispatch)
  human_ba         dynamic human-trajectory BA (cadenced, OffLineTrack)
  map.triangulate  CreateNewMapPoints (one dispatch / keyframe)
  map.fuse         SearchInNeighbors both directions
  ba.solve / ba.writeback   static local BA device solve / host write-back
  map.*            culling, vocab transform, loop closing

Usage:  python tools/profile_stages.py [n_frames]   (runs on JAX's default
backend: the GPU where there is one, the CPU under JAX_PLATFORMS=cpu; the
frames/s it prints are those of that backend).
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def _cfg(human: bool):
    from airdos_tpu.config import SlamConfig
    from airdos_tpu.io.synthetic import default_camera
    cfg = SlamConfig()
    cfg.camera = default_camera()
    cfg.orb.n_features = 1000
    cfg.orb.n_levels = 8
    cfg.human.ok = human
    cfg.human.is_seg = human
    cfg.system.is_mask = human
    if human:
        cfg.camera.fps = 5.0
    cfg.system.is_offline = True
    cfg.device.max_keypoints = 2048
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 2048
    cfg.device.max_ba_edges = 8192
    cfg.device.max_trajectories = 8
    cfg.device.max_trajectory_len = 16
    return cfg


def run(human: bool, n: int):
    from airdos_tpu.io.synthetic import SyntheticStereoWorld
    from airdos_tpu.slam.system import System
    world = SyntheticStereoWorld(seed=2, n_points=500,
                                 n_humans=10 if human else 0,
                                 crowd=human)
    Rwc, twc = world.trajectory(n, 0.1, yaw_rate=0.005)
    frames = [world.frame(i, Rwc[i], twc[i], i * 0.1, with_humans=human)
              for i in range(n)]
    slam = System(_cfg(human))
    fn = slam.track_stereo_human if human else slam.track_stereo
    for f in frames[:4]:            # warm-up / compile
        fn(f)
    slam.profiler.stages.clear()
    t0 = time.perf_counter()
    for f in frames[4:]:
        fn(f)
    wall = time.perf_counter() - t0
    name = "human (flagship)" if human else "static"
    print(f"\n=== {name} pipeline: {n - 4} timed frames, "
          f"{(n - 4) / wall:.2f} fps ===")
    print(slam.profiler.summary())
    slam.shutdown()


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 18
    run(False, n)
    run(True, n)
