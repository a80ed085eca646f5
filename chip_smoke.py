#!/usr/bin/env python3
"""Smoke test of the stereo dynamic-SLAM main path on the GPU.

    python chip_smoke.py               # one card: phases 0-5
    python chip_smoke.py --four-cards  # four cards: only the sharded path

Everything runs in this one process (a JAX process reserves most of the
card's memory, so a second one could not start).  Phases:

0. device: JAX's devices, the card's name and power limit, the native
   host extension built from source (tools/build_native.sh);
1. kernel parity at the deployment's widths against the plain numpy
   references of airdos_tpu.ops.reference, with each op's median time;
2. static tracking online through System.track_stereo (mapping and
   loop-closing workers live) on the TartanAir-Shibuya deployment of
   bench.py: 1500 ORB features, 8 levels, 640x360;
3. human tracking online through System.track_stereo_human on the
   10-person crowd, with the background human BA;
4. the AirDOS result offline: human-BA ATE below the static pipeline's;
5. the map-scale solvers (local BA, 200-keyframe global BA) against the
   same solve on the CPU device.

With --four-cards it runs only the sharded solvers over a 4-card mesh
against their one-card solvers, and a short online System run with
device.n_chips=4 against n_chips=1.

A failed check raises and the script exits non-zero.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
Where JAX finds no GPU, it exits non-zero before any phase.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Tolerances, and why each holds.
ANGLE_TOL_DEG = 1e-3     # float32 moment sums vs the float64 reference
ATE_BOUND_M = 0.5        # tightest full-tracking ATE band of the CPU suite
                         # (tests/test_config_flags.py; test_system_e2e.py
                         # allows 2.0 m on its smaller camera)
SOLVER_COST_RTOL = 1e-2  # float32 LM on two backends: summation order
SOLVER_COST_ATOL = 1e-4  # px^2; noise-free problems end at float32 roundoff
SOLVER_POSE_ATOL = 1e-2  # metres, camera translation GPU vs CPU
SHARD_POSE_ATOL = 2e-3   # metres, sharded vs one-card (test_sharded_ba.py)
N_WARM, N_TIMED = 8, 20          # bench.py's static protocol
N_WARM_H, N_TIMED_H = 7, 20      # bench.py's human protocol


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    """Raise on a failed check (the phase, and the script, fail)."""
    if not ok:
        raise AssertionError(what)


def median_ms(fn, *args, n=20):
    """Median wall time of fn(*args) to completion, after warm-up."""
    import jax
    out = jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts)) * 1e3


# --------------------------------------------------------------- phase 0
def phase_device(n_cards: int):
    import jax
    devs = jax.devices()
    dev = devs[0]
    log("jax.devices():", devs)
    log("platform:", dev.platform, "device_kind:", dev.device_kind)
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {devs}")
    if len(devs) < n_cards:
        sys.exit(f"needs {n_cards} GPUs; JAX found {len(devs)}")
    import bench
    cards = bench._card()
    log("card (name, power limit):", cards.replace("\n", " | "))
    import importlib.util
    log("cv2 importable here (not used on this path):",
        importlib.util.find_spec("cv2") is not None)
    t0 = time.perf_counter()
    subprocess.run(["sh", str(REPO / "tools" / "build_native.sh")],
                   check=True, cwd=REPO, capture_output=True,
                   env={**os.environ, "PYTHON": sys.executable})
    import airdos_tpu.slam.map as map_mod
    check(map_mod._native is not None, "native extension did not load")
    log(f"native extension built from source in "
        f"{time.perf_counter() - t0:.1f} s")
    return dev, cards.splitlines()[0]


# --------------------------------------------------------------- phase 1
def phase_kernels(image: np.ndarray, n_keypoints: int = 2048,
                  n_levels: int = 8, scale: float = 1.2):
    """Front-end ops at the deployment's widths vs the numpy references:
    Hamming at n_keypoints^2, rBRIEF, IC angles and SAD windows at the
    extractor's own n_keypoints keypoints over the n_levels pyramid."""
    import jax
    import jax.numpy as jnp
    from airdos_tpu.features.orb import OrbExtractor
    from airdos_tpu.matching.stereo import sad_windows, stack_pyramid
    from airdos_tpu.ops import reference as ref
    from airdos_tpu.ops.brief import compute_descriptors
    from airdos_tpu.ops.filters import gaussian_blur7
    from airdos_tpu.ops.hamming import hamming_matrix
    from airdos_tpu.ops.orientation import keypoint_angles
    from airdos_tpu.ops.pyramid import build_pyramid

    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, (n_keypoints, 8), dtype=np.uint64) \
        .astype(np.uint32)
    b = rng.integers(0, 1 << 32, (n_keypoints, 8), dtype=np.uint64) \
        .astype(np.uint32)
    d, ms = median_ms(jax.jit(hamming_matrix), jnp.asarray(a),
                      jnp.asarray(b))
    check(np.array_equal(np.asarray(d), ref.hamming_matrix(a, b)),
          "Hamming matrix differs from the numpy popcount")
    log(f"hamming {n_keypoints}x{n_keypoints}: exact, median {ms:.4f} ms")

    ext = OrbExtractor(n_features=n_keypoints, n_levels=n_levels,
                       scale_factor=scale)
    img = jnp.asarray(image, jnp.float32)
    feats = jax.device_get(ext(img))
    pyr = jax.jit(lambda im: build_pyramid(im, None, n_levels, scale)
                  .images)(img)
    blur = jax.jit(lambda ims: [gaussian_blur7(im) for im in ims])(pyr)
    kp = []
    for lvl in range(n_levels):
        sel = feats.valid & (feats.octave == lvl)
        xy = feats.xy[sel] / np.float32(scale ** lvl)
        kp.append((jnp.asarray(np.rint(xy[:, 0]).astype(np.int32)),
                   jnp.asarray(np.rint(xy[:, 1]).astype(np.int32))))
    n_kp = sum(int(k[0].shape[0]) for k in kp)
    log(f"keypoints from the extractor: {n_kp} over {n_levels} levels")

    angles_fn = jax.jit(lambda ims, kp: [keypoint_angles(im, x, y)
                                         for im, (x, y) in zip(ims, kp)])
    ang, ms = median_ms(angles_fn, pyr, kp)
    err = max(float(np.max(np.abs((np.asarray(g) - ref.ic_angles(
        np.asarray(im), np.asarray(x), np.asarray(y)) + 180.0) % 360.0
        - 180.0), initial=0.0)) for g, im, (x, y) in zip(ang, pyr, kp))
    log(f"IC angles: max |err| {err:.3g} deg (tolerance {ANGLE_TOL_DEG}), "
        f"median {ms:.4f} ms")
    check(err <= ANGLE_TOL_DEG, f"IC angle error {err} deg")

    desc_fn = jax.jit(lambda bl, kp, ang: [
        compute_descriptors(im, x, y, a)
        for im, (x, y), a in zip(bl, kp, ang)])
    desc, ms = median_ms(desc_fn, blur, kp, ang)
    n_ties = n_bad = 0
    for g, im, (x, y), an in zip(desc, blur, kp, ang):
        want, tie = ref.brief_descriptors(np.asarray(im), np.asarray(x),
                                          np.asarray(y), np.asarray(an))
        n_ties += int(tie.sum())
        n_bad += int((np.asarray(g) != want).any(axis=1)[~tie].sum())
    log(f"rBRIEF: {n_bad} keypoints differ from the reference "
        f"({n_ties} with a rounding tie in the rotated pattern excluded), "
        f"median {ms:.4f} ms")
    check(n_bad == 0, f"{n_bad} descriptors not bit-exact")

    pyr_r = [jnp.roll(im, -3, axis=1) for im in pyr]
    sl, sr = stack_pyramid(pyr), stack_pyramid(pyr_r)
    h0, w0 = sl.shape[1:]
    oct_l = np.concatenate([np.full(k[0].shape[0], l, np.int32)
                            for l, k in enumerate(kp)])
    xs = np.concatenate([np.asarray(k[0]) for k in kp])
    ys = np.concatenate([np.asarray(k[1]) for k in kp])
    d5, d10 = np.arange(-5, 6), np.arange(-10, 11)
    gy = np.clip(ys[:, None] + d5, 0, h0 - 1)
    gxl = np.clip(xs[:, None] + d5, 0, w0 - 1)
    gxr = np.clip(xs[:, None] - 4 + d10, 0, w0 - 1)
    (pl_, pr_), ms = median_ms(jax.jit(sad_windows), sl, sr,
                               jnp.asarray(oct_l), jnp.asarray(gy),
                               jnp.asarray(gxl), jnp.asarray(gxr))
    wl, wr = ref.sad_windows(np.asarray(sl), np.asarray(sr), oct_l, gy,
                             gxl, gxr)
    check(np.array_equal(np.asarray(pl_), wl)
          and np.array_equal(np.asarray(pr_), wr),
          "SAD windows differ from the reference")
    log(f"SAD windows: exact, median {ms:.4f} ms")


# ----------------------------------------------------------- phases 2-3
def _cpu_only_worker():
    """Render workers never touch the card."""
    os.environ["JAX_PLATFORMS"] = "cpu"


def _render(job):
    """Frame i of a seeded synthetic world; numpy only."""
    from airdos_tpu.io.synthetic import SyntheticStereoWorld
    world_kw, i, Rwc, twc, humans = job
    return SyntheticStereoWorld(**world_kw).frame(i, Rwc, twc, i * 0.1,
                                                  with_humans=humans)


def render_pool():
    """Worker processes for the host-side rendering (set-up time)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                               mp_context=multiprocessing.get_context("spawn"),
                               initializer=_cpu_only_worker)


def _frames(world_kw, Rwc, twc, humans, pool):
    jobs = [(world_kw, i, Rwc[i], twc[i], humans) for i in range(len(Rwc))]
    return list(map(_render, jobs) if pool is None else pool.map(_render, jobs))


def static_frames(n: int, cam=None, pool=None):
    """bench.py's seed-0 static world: (frames, ground-truth positions)."""
    from airdos_tpu.io.synthetic import SyntheticStereoWorld
    kw = dict(seed=0, n_points=500, cam=cam)
    Rwc, twc = SyntheticStereoWorld(**kw).trajectory(n, 0.1, speed=0.3,
                                                     yaw_rate=0.005)
    return _frames(kw, Rwc, twc, False, pool), twc


def crowd_frames(n: int, n_humans: int, cam=None, pool=None):
    """bench.py's seed-2 crowd: (frames, ground-truth positions)."""
    from airdos_tpu.io.synthetic import SyntheticStereoWorld
    kw = dict(seed=2, n_points=500, n_humans=n_humans, crowd=True, cam=cam)
    Rwc, twc = SyntheticStereoWorld(**kw).trajectory(n, 0.1, yaw_rate=0.005)
    return _frames(kw, Rwc, twc, True, pool), twc


def run_system(cfg, frames, gts, n_warm: int, human: bool, card: str,
               require_ok: bool = True):
    """Track frames through the System entry point (online or offline as
    cfg says); checks an OK state and a finite pose on every frame and
    the ATE bound unless require_ok is False.  Returns (System, ATE)."""
    import jax
    from airdos_tpu.io.tum import ate_rmse
    from airdos_tpu.slam.system import System
    slam = System(cfg)
    track = slam.track_stereo_human if human else slam.track_stereo
    states = []
    t_setup = time.perf_counter()
    for i, f in enumerate(frames):
        if i == n_warm:
            setup_s = time.perf_counter() - t_setup
            t0 = time.perf_counter()
        if i + 1 < len(frames):
            slam.prefetch(frames[i + 1])
        track(f)
        fr = slam.tracking.last_frame
        states.append((slam.tracking.state.name,
                       bool(np.isfinite(fr.Rcw).all()
                            and np.isfinite(fr.tcw).all())))
    dt = time.perf_counter() - t0
    slam.shutdown()
    _, _, twc_e = slam.tracking.trajectory_tum()
    ate = float(ate_rmse(twc_e, np.asarray(gts)[:len(twc_e)]))
    if not require_ok:
        return slam, ate
    bad = [(i, s) for i, s in enumerate(states) if s != ("OK", True)]
    check(not bad, f"frames not OK with a finite pose: {bad}")
    fps = (len(frames) - n_warm) / dt
    mem = jax.devices()[0].memory_stats() or {}
    log(f"  {len(frames)} frames OK; {fps:.3f} frames/s over "
        f"{len(frames) - n_warm} timed frames on {card}; set-up "
        f"(compile-bearing warm-up of {n_warm} frames) {setup_s:.1f} s")
    log(f"  keyframes {slam.map.n_keyframes()}, map points "
        f"{slam.map.n_points()}, loop closer live "
        f"{slam.loop_closer is not None}, peak_bytes_in_use "
        f"{mem.get('peak_bytes_in_use')}")
    log(f"  ATE RMSE {ate:.5f} m (bound {ATE_BOUND_M} m)")
    check(ate < ATE_BOUND_M, f"ATE {ate} m above {ATE_BOUND_M} m")
    return slam, ate


def check_human_ba(slam):
    n = slam.human_ba.n_runs
    trajs = [t for t in slam.map.trajectories.values() if t.optimized]
    finite = all(np.isfinite(t.segment_len).all()
                 and all(np.isfinite(p.joints_w[p.optimized]).all()
                         for p in t.poses) for t in trajs)
    log(f"  human BA completions {n}, optimized trajectories {len(trajs)}, "
        f"joints and limb lengths finite {finite}")
    check(n >= 1, "the background human BA never completed")
    check(bool(trajs) and finite, "no optimized trajectory with finite "
          "joints and limb lengths")


# --------------------------------------------------------------- phase 5
def ba_cost(R, t, pts, e_cam, e_pt, e_obs, fx, fy, cx, cy, bf):
    """Mean squared stereo reprojection error (px^2), float64."""
    R, t, pts = (np.asarray(v, np.float64) for v in (R, t, pts))
    xc = np.einsum("eij,ej->ei", R[e_cam], pts[e_pt]) + t[e_cam]
    z = xc[:, 2]
    u = fx * xc[:, 0] / z + cx
    pred = np.stack([u, fy * xc[:, 1] / z + cy, u - bf / z], axis=1)
    return float(np.mean(np.sum((np.asarray(e_obs) - pred) ** 2, axis=1)))


def phase_solvers():
    import jax
    import bench
    cpu = jax.devices("cpu")[0]
    for name, make in (("local BA", bench.local_ba_problem),
                       ("global BA 200 KF", bench.global_ba_problem)):
        fn, args, kw = make()
        (R0, t0, _, p0, _, e_cam, e_pt, e_obs, *_r), scal = \
            args[:10], args[10:]
        edges = [np.asarray(v) for v in (e_cam, e_pt, e_obs)]
        before = ba_cost(R0, t0, p0, *edges, *scal)
        t_s = time.perf_counter()
        gpu = jax.block_until_ready(fn(*args, **kw))
        compile_s = time.perf_counter() - t_s
        _, ms = median_ms(lambda: fn(*args, **kw), n=3)
        cpu_args = tuple(jax.device_put(a, cpu) if hasattr(a, "shape")
                         else a for a in args)
        ref = jax.block_until_ready(fn(*cpu_args, **kw))
        c_gpu = ba_cost(gpu.R, gpu.t, gpu.points, *edges, *scal)
        c_cpu = ba_cost(ref.R, ref.t, ref.points, *edges, *scal)
        dt = float(np.max(np.abs(np.asarray(gpu.t) - np.asarray(ref.t))))
        log(f"{name}: cost {before:.5g} -> {c_gpu:.5g} px^2 on the GPU, "
            f"{c_cpu:.5g} on the CPU; max |t_gpu - t_cpu| {dt:.3g} m; "
            f"{ms:.2f} ms per solve (compile {compile_s:.1f} s)")
        check(c_gpu < before, f"{name} did not lower its cost")
        check(abs(c_gpu - c_cpu) <= SOLVER_COST_RTOL * c_cpu
              + SOLVER_COST_ATOL, f"{name} cost {c_gpu} vs CPU {c_cpu}")
        check(dt <= SOLVER_POSE_ATOL, f"{name} poses differ by {dt} m")


# ------------------------------------------------------- --four-cards
def human_problem(rng, C=8, P=1024, T=8, L=8):
    """Human-BA problem at the local-BA widths: C cameras, P static points
    seen by half the cameras each, T walking skeletons of L poses."""
    from airdos_tpu.io.synthetic import _SKELETON_REST
    from airdos_tpu.slam.map import BODY1, BODY2
    fx = fy = 772.5
    cx, cy, bf = 320.0, 180.0, 193.1
    dt = 0.5
    skel = _SKELETON_REST[:14].astype(np.float32)
    cam_t = np.stack([np.array([0.05 * c, 0, -0.3 * c], np.float32)
                      for c in range(C)])
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-3, 3, P),
                    rng.uniform(3, 25, P)], axis=1).astype(np.float32)
    es_cam = np.repeat(np.arange(C, dtype=np.int32), P // 2)
    es_pt = np.concatenate([rng.permutation(P)[:P // 2] for _ in range(C)]
                           ).astype(np.int32)

    def project(xw, c, noise):
        xc = xw + cam_t[c]
        u = fx * xc[..., 0] / xc[..., 2] + cx
        v = fy * xc[..., 1] / xc[..., 2] + cy
        obs = np.stack([u, v, u - bf / xc[..., 2]], axis=-1)
        return (obs + rng.normal(0, noise, obs.shape)).astype(np.float32)

    es_obs = project(pts[es_pt], es_cam, 0.3)
    joints = np.zeros((T, L, 14, 3), np.float32)
    jo_cam = np.zeros((T, L), np.int32)
    for k in range(T):
        base = np.array([rng.uniform(-3, 3), 0.2, rng.uniform(6, 12)],
                        np.float32)
        vel = np.array([rng.uniform(-0.5, 0.5), 0, rng.uniform(-0.3, 0.3)],
                       np.float32)
        for l in range(L):
            joints[k, l] = skel + base + vel * (l * dt)
            jo_cam[k, l] = l % C
    jo_obs = project(joints, jo_cam[..., None], 0.3)
    seg0 = np.linalg.norm(joints[:, 0, BODY1] - joints[:, 0, BODY2],
                          axis=-1).astype(np.float32)
    joints0 = joints + rng.normal(0, 0.05, joints.shape).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    ones = np.ones((T, L, 14), bool)
    return (np.tile(np.eye(3, dtype=np.float32), (C, 1, 1)), cam_t, fixed,
            pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
            np.ones(P, bool), es_cam, es_pt, es_obs,
            np.ones(len(es_cam), np.float32), np.ones(len(es_cam), bool),
            joints0, ones, jo_cam, jo_obs, ones, seg0,
            np.ones((T, 14), bool), ones,
            np.tile(np.eye(3, dtype=np.float32), (T, 1, 1)),
            np.zeros((T, 3), np.float32), np.ones(T, bool),
            np.full((T, L), dt, np.float32), np.ones((T, L, 5), bool),
            1.0, 0.5, 20.0, 20.0, 1.0, 4.0, 1.0, fx, fy, cx, cy, bf)


def pad_edges(args, n_dev):
    """Pad the 5 edge columns (indices 5-9) to a multiple of n_dev rows;
    pad rows are invalid."""
    args = list(args)
    E = np.asarray(args[5]).shape[0]
    pad = (-E) % n_dev
    for i in range(5, 10):
        a = np.asarray(args[i])
        args[i] = np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                              a.dtype)])
    return tuple(args)


def phase_four_cards(card: str):
    import jax
    import jax.numpy as jnp
    import bench
    from airdos_tpu.parallel.sharded_ba import (
        make_mesh, sharded_epnp_ransac, sharded_global_bundle_adjust,
        sharded_human_bundle_adjust, sharded_local_bundle_adjust)
    from airdos_tpu.solvers.epnp import epnp_ransac
    from airdos_tpu.solvers.human_ba import human_bundle_adjust

    mesh = make_mesh(4)
    for name, make, sharded in (
            ("local BA", bench.local_ba_problem,
             lambda kw: sharded_local_bundle_adjust(mesh, **kw)),
            ("global BA 200 KF", bench.global_ba_problem,
             lambda kw: sharded_global_bundle_adjust(mesh, **kw))):
        fn, args, kw = make()
        args = pad_edges(jax.device_get(args), 4)
        one = fn(*args, **kw)
        t0 = time.perf_counter()
        four = jax.block_until_ready(sharded(kw)(*args))
        s = time.perf_counter() - t0
        dt = float(np.max(np.abs(np.asarray(four.t) - np.asarray(one.t))))
        log(f"sharded {name} over 4 cards: max |t4 - t1| {dt:.3g} m "
            f"(first call incl. compile {s:.1f} s)")
        check(dt <= SHARD_POSE_ATOL, f"sharded {name} differs by {dt} m")

    rng = np.random.default_rng(0)
    hargs = pad_edges(human_problem(rng), 4)
    one = human_bundle_adjust(*hargs, iters1=5, iters2=10)
    four = sharded_human_bundle_adjust(mesh, iters1=5, iters2=10)(*hargs)
    dt = float(np.max(np.abs(np.asarray(four.cam_t) -
                             np.asarray(one.cam_t))))
    dj = np.linalg.norm(np.asarray(four.joints) - np.asarray(one.joints),
                        axis=-1)
    # single-view stereo joints are weakly constrained in depth, so the
    # psum's summation order moves a few of them: compare the median
    log(f"sharded human BA over 4 cards: max |cam_t4 - cam_t1| {dt:.3g} m, "
        f"joints4 - joints1 median {np.median(dj):.3g} m, max "
        f"{dj.max():.3g} m")
    check(dt <= SHARD_POSE_ATOL and np.median(dj) <= 5e-3,
          "sharded human BA differs")

    fx = fy = 772.5
    cx, cy = 320.0, 180.0
    n = 1024
    pw = np.stack([rng.uniform(-6, 6, n), rng.uniform(-3, 3, n),
                   rng.uniform(3, 25, n)], axis=1).astype(np.float32)
    xc = pw + np.array([0.2, -0.1, 0.4], np.float32)
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], axis=1)
    uv += rng.normal(0, 0.3, uv.shape)
    out = rng.permutation(n)[:n // 4]
    uv[out] += rng.uniform(20, 60, (len(out), 2))
    pargs = (jnp.asarray(pw), jnp.asarray(uv.astype(np.float32)),
             jnp.ones(n, bool), jnp.full(n, 5.991, jnp.float32),
             jnp.asarray(rng.integers(0, n, (512, 4)).astype(np.int32)),
             fx, fy, cx, cy)
    one = epnp_ransac(*pargs)
    four = sharded_epnp_ransac(mesh)(*pargs)
    log(f"sharded EPnP RANSAC over 4 cards: inliers {int(four.n_inliers)} "
        f"vs {int(one.n_inliers)} on one card")
    check(int(four.n_inliers) == int(one.n_inliers)
          and np.array_equal(np.asarray(four.inliers),
                             np.asarray(one.inliers)),
          "sharded EPnP RANSAC differs")

    with render_pool() as pool:
        frames, gts = static_frames(12, pool=pool)
    ates = {}
    for n_chips in (1, 4):
        cfg = bench._cfg(human=False)
        cfg.system.is_offline = False
        cfg.device.n_chips = n_chips
        log(f"static online System, device.n_chips={n_chips}:")
        _, ates[n_chips] = run_system(cfg, frames, gts, 4, False, card)
    log(f"ATE n_chips=4 {ates[4]:.5f} m vs n_chips=1 {ates[1]:.5f} m")


# ------------------------------------------------------------------ main
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over four cards")
    opts = ap.parse_args()
    n_cards = 4 if opts.four_cards else 1

    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"   # phase 5's reference
    import jax
    sys.path.insert(0, str(REPO))
    dev, card = phase_device(n_cards)
    import airdos_tpu  # noqa: F401  (precision + compile cache)

    if opts.four_cards:
        phase_four_cards(card)
    else:
        import bench
        t0 = time.perf_counter()
        with render_pool() as pool:
            frames, gts = static_frames(N_WARM + N_TIMED, pool=pool)
            frames_h, gts_h = crowd_frames(N_WARM_H + N_TIMED_H,
                                           bench.N_HUMANS, pool=pool)
        log(f"rendered {len(frames) + len(frames_h)} frames in "
            f"{time.perf_counter() - t0:.1f} s (set-up)")

        log("phase 1: kernel parity")
        phase_kernels(frames[0].image_left)

        log("phase 2: static tracking, online")
        cfg = bench._cfg(human=False)
        cfg.system.is_offline = False
        run_system(cfg, frames, gts, N_WARM, False, card)

        log("phase 3: human tracking, online")
        cfg = bench._cfg(human=True)
        cfg.system.is_offline = False
        slam, _ = run_system(cfg, frames_h, gts_h, N_WARM_H, True, card)
        check_human_ba(slam)

        log("phase 4: AirDOS result, offline")
        _, ate_human = run_system(bench._cfg(human=True), frames_h, gts_h,
                                  N_WARM_H, True, card, require_ok=False)
        cfg = bench._cfg(human=False)      # no masks: crowd texture leaks in
        cfg.system.is_mask = False
        cfg.camera.fps = 5.0
        _, ate_static = run_system(cfg, frames_h, gts_h, N_WARM_H, False,
                                   card, require_ok=False)
        log(f"  ate_rmse_human {ate_human:.5f} m, ate_rmse_static "
            f"{ate_static:.5f} m")
        check(ate_human < ate_static, "human-BA ATE not below static ATE")

        log("phase 5: map-scale solvers vs the CPU")
        phase_solvers()

    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
