"""Benchmark: end-to-end SLAM throughput + accuracy on the GPU.

Needs a GPU: on any other platform it exits with an error before timing
anything.  Every result names the device (platform, device_kind, count)
and the card's name and power limit as nvidia-smi reports them.

Sections, one JSON line:

1. tracking_fps        — static stereo pipeline (frame front-end + matching
                         + pose optimization + keyframing/local BA) on the
                         TartanAir-Shibuya camera geometry (640x360,
                         fx 772.5) at the REFERENCE'S OWN feature budget:
                         1500 ORB features, 8 levels, scale 1.2
                         (tartanair.yaml:38-44).  Median over BENCH_REPS
                         independent runs.  Runs ONLINE (tracking ||
                         mapping threads, the reference's static
                         architecture, System.cc:87-96); the human
                         sections run offline (the paper configuration).
2. tracking_fps_human  — the flagship dynamic pipeline: masked extraction,
                         human stereo association, human-trajectory BA.
                         Measured ONLINE like the static section: mapping
                         runs in its worker thread and the human BA solve
                         runs in its own background thread under the
                         StaticLocalBA lock discipline, so the tracking
                         thread never blocks on the dense reduced solve.
3. ate_rmse_static / ate_rmse_human — the AirDOS headline: on a crowded
                         dynamic scene (textured moving humans rendered
                         into the images), the masked+human-BA pipeline vs
                         the static pipeline that ingests the moving
                         texture.  The AirDOS claim is human < static.
                         Measured OFFLINE (synchronous, deterministic —
                         the paper configuration, OffLineTrack
                         Tracking.cc:705-717), one run each.
4. local_ba_iters_per_sec / gba_200kf_wall_s — solver throughput
                         (BASELINE.md targets table).
5. stages              — median ms per pipeline stage (front-end fused
                         step, host prep/pack/assoc, keyframing, mapping
                         pipeline, human BA), the reference's per-stage
                         chrono discipline (stereo_human.cc:148-150,
                         Tracking.cc:713-715), plus an MFU estimate of the
                         fused tracking step from XLA cost analysis.

Baseline: the reference's real-time budget on this dataset is 2.0 fps
(Camera.fps, tartanair.yaml:22; BASELINE.md) — the reference repo records
no faster number.  vs_baseline = tracking_fps / 2.0.
"""
import json
import time

import numpy as np

BENCH_REPS = 3
N_HUMANS = 10         # crowd density of the dynamic scene (Shibuya-like,
                      # ~34% pixel coverage mid-sequence)


def _require_gpu():
    """The device every timing below runs on; a non-GPU platform is an
    error, never a fallback."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    return dev


def _card():
    """Card name and power limit, as nvidia-smi reports them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _cfg(human: bool):
    from airdos_tpu.config import SlamConfig
    from airdos_tpu.io.synthetic import default_camera
    cfg = SlamConfig()
    cfg.camera = default_camera()          # TartanAir-Shibuya geometry
    cfg.orb.n_features = 1500              # the reference's own budget
    cfg.orb.n_levels = 8                   # (tartanair.yaml:38-44)
    cfg.human.ok = human
    cfg.human.is_seg = human
    cfg.system.is_mask = human
    if human:
        # human-trajectory BA fires every Camera.fps frames (OffLineTrack
        # cadence): fps=5 puts the first, compile-bearing call inside the
        # warm-up window of a short sequence
        cfg.camera.fps = 5.0
    # offline (synchronous, deterministic) — the paper configuration
    cfg.system.is_offline = True
    cfg.device.max_keypoints = 2048
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 2048
    cfg.device.max_ba_edges = 8192
    cfg.device.max_trajectories = 8
    # 8-pose windows match the 8-KF local window and keep the human-BA
    # bucket at one stable compiled shape for the whole run
    cfg.device.max_trajectory_len = 8
    return cfg


def _run(cfg, frames, gts, n_warm):
    from airdos_tpu.io.tum import ate_rmse
    from airdos_tpu.slam.system import System
    slam = System(cfg)
    fn = slam.track_stereo_human if cfg.human.ok else slam.track_stereo
    for i in range(n_warm):
        if i + 1 < len(frames):
            slam.prefetch(frames[i + 1])   # overlap upload with compute
        fn(frames[i])
    # per-stage medians over TIMED frames only (drop compile-bearing warmup)
    slam.profiler.stages.clear()
    t0 = time.perf_counter()
    for i in range(n_warm, len(frames)):
        if i + 1 < len(frames):
            slam.prefetch(frames[i + 1])
        fn(frames[i])
    dt = time.perf_counter() - t0
    fps = (len(frames) - n_warm) / dt
    cost = slam.tracking.fused_cost_analysis()
    # drain the mapping thread (online mode) before reading the trajectory
    slam.shutdown()
    stages = slam.profiler.report()
    ts, Rwc, twc = slam.tracking.trajectory_tum()
    ate = float(ate_rmse(twc, np.asarray(gts)[: len(twc)])) if len(twc) >= 5 \
        else float("nan")
    return fps, ate, stages, cost


def _run_reps(cfg_fn, frames, gts, n_warm, reps=BENCH_REPS):
    """Median fps / ATE over independent runs (compile amortized by the
    in-process + persistent XLA caches after the first).  Stage medians
    and the fused-step cost analysis come from the LAST rep (warm)."""
    fpss, ates = [], []
    stages = cost = None
    for _ in range(reps):
        fps, ate, stages, cost = _run(cfg_fn(), frames, gts, n_warm)
        fpss.append(fps)
        ates.append(ate)
    return float(np.median(fpss)), float(np.median(ates)), stages, cost


# Published peaks per device_kind (NVIDIA H100 data sheet, SXM part, dense
# rates without sparsity, at the full 700 W power limit).
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "f32_flops": 67e12,          # float32 outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
    },
}


def _peaks(device_kind: str) -> dict:
    """Peak rates of one device; a device missing from the table is an
    error, not a default."""
    try:
        return _PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; add them to bench._PEAKS") from None


def _stage_summary(stages_static, stages_human_on, stages_human_off, cost):
    """Median ms per stage + MFU estimate of the fused tracking step."""
    out = {}

    def med_ms(rep, key):
        v = rep.get(key) if rep else None
        return round(v["median_s"] * 1e3, 2) if v else None

    for key, label in (("track.step", "fused_step_ms"),
                       ("track.prep", "host_prep_ms"),
                       ("track.pack", "host_pack_ms"),
                       ("track.assoc", "host_assoc_ms"),
                       ("track.kf", "keyframe_ms"),
                       ("track", "track_total_ms"),
                       ("map.triangulate", "map_triangulate_ms"),
                       ("map.fuse", "map_fuse_ms"),
                       ("map.static_ba", "map_static_ba_ms"),
                       ("map.cull_points", "map_cull_points_ms"),
                       ("map.cull_kfs", "map_cull_kfs_ms")):
        v = med_ms(stages_static, key)
        if v is not None:
            out[label] = v
    hv = med_ms(stages_human_off, "human_ba")
    if hv is not None:
        out["human_ba_ms"] = hv            # synchronous (offline) solve
    hv = med_ms(stages_human_on, "track.step")
    if hv is not None:
        out["fused_step_human_ms"] = hv
    hv = med_ms(stages_human_on, "track")
    if hv is not None:
        out["track_total_human_ms"] = hv
    if cost and cost.get("flops") and stages_static and \
            stages_static.get("track.step"):
        import jax
        # the step runs every contraction at "highest" float32 precision,
        # so its FLOPs are measured against the float32 peak
        peak = _peaks(jax.devices()[0].device_kind)["f32_flops"]
        step_s = stages_static["track.step"]["median_s"]
        out["fused_step_gflops"] = round(cost["flops"] / 1e9, 2)
        out["fused_step_mfu_pct"] = round(
            100.0 * cost["flops"] / step_s / peak, 3)
        if cost.get("bytes_accessed"):
            out["fused_step_gbytes"] = round(cost["bytes_accessed"] / 1e9, 3)
    return out


def local_ba_problem():
    """Representative local-BA window problem (8 cams, 1024 points, ~4k
    stereo edges): (jitted solver, args, static kwargs)."""
    import jax
    import jax.numpy as jnp
    from airdos_tpu.solvers.local_ba import local_bundle_adjust
    rng = np.random.default_rng(0)
    fx = fy = 772.5
    cx, cy, bf = 320.0, 180.0, 193.1
    C, P = 8, 1024
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-3, 3, P),
                    rng.uniform(3, 25, P)], axis=1).astype(np.float32)
    cam_t = np.stack([np.array([0.05 * c, 0, -0.3 * c], np.float32)
                      for c in range(C)])
    cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    e_cam = np.repeat(np.arange(C, dtype=np.int32), P // 2)
    e_pt = np.concatenate([rng.permutation(P)[: P // 2].astype(np.int32)
                           for _ in range(C)])
    xc = pts[e_pt] + cam_t[e_cam]
    z = np.maximum(xc[:, 2], 0.5)
    u = fx * xc[:, 0] / z + cx
    v = fy * xc[:, 1] / z + cy
    e_obs = np.stack([u + rng.normal(0, 0.3, len(u)),
                      v + rng.normal(0, 0.3, len(u)),
                      u - bf / z], axis=1).astype(np.float32)
    E = len(e_cam)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    fn = jax.jit(local_bundle_adjust, static_argnames=("iters1", "iters2"))
    args = (jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(fixed),
            jnp.asarray(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
            jnp.ones(P, bool),
            jnp.asarray(e_cam), jnp.asarray(e_pt), jnp.asarray(e_obs),
            jnp.ones(E, jnp.float32), jnp.ones(E, bool),
            fx, fy, cx, cy, bf)
    # the reference protocol's 5 Huber + 10 plain LM iterations
    return fn, args, dict(iters1=5, iters2=10)


def _bench_local_ba():
    """Local-BA LM iterations/sec on local_ba_problem()."""
    import jax
    fn, args, kw = local_ba_problem()
    n_iters = kw["iters1"] + kw["iters2"]
    jax.block_until_ready(fn(*args, **kw))      # compile
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return n_iters / float(np.median(times))


def global_ba_problem():
    """200-KF / 3000-point / ~12k-edge map for a 20-iteration global BA
    (matrix-free Schur+PCG): (jitted solver, args, static kwargs)."""
    import jax
    import jax.numpy as jnp
    from airdos_tpu.solvers.global_ba import global_bundle_adjust
    rng = np.random.default_rng(0)
    fx = fy = 300.0
    cx, cy, bf = 160.0, 120.0, 60.0
    C, P = 200, 3000
    cam_t_gt = np.stack([np.array([0.01 * c, 0.0, 0.25 * c])
                         for c in range(C)]).astype(np.float32)
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-4, 4, P),
                    rng.uniform(2, 0.25 * C + 10, P)], axis=1).astype(np.float32)
    e_cam, e_pt, e_obs = [], [], []
    for c in range(C):
        xc = pts - cam_t_gt[c]
        z = xc[:, 2]
        u = fx * xc[:, 0] / np.where(z > 0.1, z, 1) + cx
        v = fy * xc[:, 1] / np.where(z > 0.1, z, 1) + cy
        ok = (z > 1.0) & (z < 25.0) & (u > 0) & (u < 320) & (v > 0) & (v < 240)
        sel = np.nonzero(ok)[0][:60]
        for p in sel:
            e_cam.append(c)
            e_pt.append(p)
            e_obs.append([u[p], v[p], u[p] - bf / z[p]])
    E = len(e_cam)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    fn = jax.jit(global_bundle_adjust,
                 static_argnames=("iters1", "iters2", "cg_iters"))
    args = (jnp.tile(jnp.eye(3), (C, 1, 1)).astype(jnp.float32),
            jnp.asarray(-cam_t_gt), jnp.asarray(fixed),
            jnp.asarray(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
            jnp.ones(P, bool),
            jnp.asarray(np.asarray(e_cam, np.int32)),
            jnp.asarray(np.asarray(e_pt, np.int32)),
            jnp.asarray(np.asarray(e_obs, np.float32)),
            jnp.ones(E, jnp.float32), jnp.ones(E, bool),
            fx, fy, cx, cy, bf)
    return fn, args, dict(iters1=10, iters2=10, cg_iters=48)


def _bench_global_ba_200kf():
    """Wall time of one global BA on global_ba_problem()."""
    import jax
    fn, args, kw = global_ba_problem()
    jax.block_until_ready(fn(*args, **kw))      # compile
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args, **kw))
    return time.perf_counter() - t0


def main():
    import jax
    dev = _require_gpu()
    _peaks(dev.device_kind)              # unknown card: fail before timing
    card = _card()
    from airdos_tpu.io.synthetic import SyntheticStereoWorld

    # 20 timed frames for the fps headline; speed scaled down so the
    # longer run covers the same ~0.7 m stable-tracking envelope the
    # 14-frame run did (drift outside it would contaminate the ATE stat,
    # not the fps).  8 warm frames cover the compile-bearing first
    # keyframes AND the first mapping-pipeline pass (triangulate + fuse +
    # local BA reach their steady bucket shapes by then)
    n_warm, n_bench = 8, 20
    n_total = n_warm + n_bench

    # --- section 1: static throughput + clean-scene accuracy ----------
    world = SyntheticStereoWorld(seed=0, n_points=500)
    Rwc, twc = world.trajectory(n_total, 0.1, speed=0.3, yaw_rate=0.005)
    frames = [world.frame(i, Rwc[i], twc[i], i * 0.1, with_humans=False)
              for i in range(n_total)]

    # The static pipeline benches ONLINE (tracking thread || mapping
    # thread), the reference's own architecture for static stereo SLAM
    # (System.cc:87-96 spawns LocalMapping); fps is the tracking-thread
    # rate, exactly what stereo_human.cc:148-150 reports.
    def cfg_static_online():
        c = _cfg(human=False)
        c.system.is_offline = False
        return c
    fps_static, ate_clean, stages_static, cost = _run_reps(
        cfg_static_online, frames, twc, n_warm)

    # --- sections 2+3: crowded dynamic scene --------------------------
    # >= 20 timed frames for the human fps statistic (a single
    # keyframe-cadence hiccup must not dominate the median)
    n_warm_h = 7
    n_total_h = n_warm_h + 20
    # crowd=True: slow coherently-drifting humans whose ~1-2 px/frame flow
    # stays inside the pose optimizer's chi-square gate — the regime where
    # an unmasked pipeline accumulates bias instead of rejecting outliers
    # (fast walkers are cleanly gated out and poison nothing)
    world_h = SyntheticStereoWorld(seed=2, n_points=500, n_humans=N_HUMANS,
                                   crowd=True)
    Rwc, twc = world_h.trajectory(n_total_h, 0.1, yaw_rate=0.005)
    frames_h = [world_h.frame(i, Rwc[i], twc[i], i * 0.1, with_humans=True)
                for i in range(n_total_h)]
    # fps: ONLINE, like the static section (mapping worker + background
    # human-BA thread — the architecture the reference gets from its
    # LocalMapping thread, System.cc:87-96)
    def cfg_human_online():
        c = _cfg(human=True)
        c.system.is_offline = False
        return c
    fps_human, _, stages_human_on, _ = _run_reps(
        cfg_human_online, frames_h, twc, n_warm_h)

    # ATE comparison: OFFLINE, synchronous and deterministic (the paper
    # configuration) — one run each side, same frames
    _, ate_human, stages_human_off, _ = _run_reps(
        lambda: _cfg(human=True), frames_h, twc, n_warm_h, reps=1)

    # static pipeline, no masks, same dynamic frames: moving-human texture
    # leaks into the static matcher
    def cfg_polluted():
        c = _cfg(human=False)
        c.system.is_mask = False
        c.camera.fps = 5.0
        return c
    _, ate_static, _, _ = _run_reps(cfg_polluted, frames_h, twc,
                                    n_warm_h, reps=1)

    # --- section 4: solver throughput ---------------------------------
    lba_ips = _bench_local_ba()
    gba_wall = _bench_global_ba_200kf()

    baseline_fps = 2.0     # dataset real-time budget (tartanair.yaml:22)
    print(json.dumps({
        "metric": "tracking_fps",
        "value": round(fps_static, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps_static / baseline_fps, 3),
        "tracking_fps_human": round(fps_human, 3),
        "ate_rmse_clean": round(ate_clean, 4),
        "ate_rmse_static": round(ate_static, 4),
        "ate_rmse_human": round(ate_human, 4),
        "local_ba_iters_per_sec": round(lba_ips, 1),
        "gba_200kf_wall_s": round(gba_wall, 3),
        "n_features": 1500,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "stages": _stage_summary(stages_static, stages_human_on,
                                 stages_human_off, cost),
    }))


if __name__ == "__main__":
    main()
