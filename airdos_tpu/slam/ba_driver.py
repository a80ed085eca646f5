"""Host-side drivers: assemble device problems from the map and write back.

- StaticLocalBA: LocalBundleAdjustment protocol (reference
  Optimizer.cc:431-731) — local covisible KFs + their points + fixed
  observers, outlier-observation erasure on write-back.
- Triangulator: CreateNewMapPoints across the 10 best covisible neighbours
  (LocalMapping.cc:221-466).
- Fuser: SearchInNeighbors both directions (LocalMapping.cc:468-548).
"""
from __future__ import annotations

import warnings
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from airdos_tpu.config import SlamConfig
from airdos_tpu.matching.epipolar import triangulate_pair
from airdos_tpu.matching.fuse import fuse_candidates
from airdos_tpu.slam.map import (BODY1, BODY2, KeyFrame, N_PARTS, SlamMap,
                                 TH_LONG_TRAJECTORY)
from airdos_tpu.solvers.local_ba import local_bundle_adjust
from airdos_tpu.utils.gate import gate_wait
from airdos_tpu.utils.obs import span


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def collect_window_points(m: SlamMap, local_ids, cap: int) -> np.ndarray:
    """Unique live map points observed by the given KFs — one vectorized
    pass over the KFs' feature->point tables instead of a per-observation
    Python loop (the reference walks mvpMapPoints per KF,
    Optimizer.cc:466-480)."""
    pt = m.points
    cols = [m.kfs[kid].mp_idx for kid in local_ids]
    if not cols:
        return np.empty(0, np.int64)
    pids = np.concatenate(cols)
    pids = np.unique(pids[pids >= 0])
    pids = pids[~pt.bad[pids]]
    return pids[:cap].astype(np.int64)


def point_slot_lookup(m: SlamMap, point_ids: np.ndarray) -> np.ndarray:
    """Dense point-id -> problem-slot table (-1 = not in the problem)."""
    sel = np.full(m.points.pos.shape[0], -1, np.int32)
    sel[point_ids] = np.arange(len(point_ids), dtype=np.int32)
    return sel


def find_fixed_observers(m: SlamMap, local_set, sel: np.ndarray,
                         max_fixed: int, tag: str) -> List[int]:
    """ALL keyframes outside the window that observe a window point anchor
    the problem (reference Optimizer.cc:506-527 lFixedCameras has no cap;
    capping drops constraints and lets window points drift).  Vectorized
    membership check per KF via the slot table."""
    fixed_ids: List[int] = []
    for kid in sorted(m.kfs):
        k = m.kfs[kid]
        if kid in local_set or k.bad:
            continue
        mp = k.mp_idx
        hit = mp[mp >= 0]
        if hit.size and (sel[hit] >= 0).any():
            fixed_ids.append(kid)
    if len(fixed_ids) > max_fixed:
        warnings.warn(f"{tag}: {len(fixed_ids)} fixed observers, "
                      f"keeping {max_fixed}")
        fixed_ids = fixed_ids[:max_fixed]
    return fixed_ids


def assemble_edges(m: SlamMap, cam_ids, sel: np.ndarray,
                   inv_sigma2: np.ndarray):
    """Stereo-projection edge table for (cam in cam_ids, point in slot
    table): one vectorized gather per camera over its feature->point
    table.  Returns unpadded columns plus the (point_id, kf_id, feat_id)
    reference columns used for outlier-observation write-back."""
    bc, bp, bo, bi = [], [], [], []
    rp, rk, rf = [], [], []
    for ci, kid in enumerate(cam_ids):
        k = m.kfs[kid]
        fid = np.nonzero(k.mp_idx >= 0)[0]
        pid = k.mp_idx[fid]
        li = sel[pid]
        keep = li >= 0
        fid, pid, li = fid[keep], pid[keep], li[keep]
        if not fid.size:
            continue
        bc.append(np.full(len(fid), ci, np.int32))
        bp.append(li.astype(np.int32))
        bo.append(np.stack([k.xy_un[fid, 0], k.xy_un[fid, 1],
                            k.u_right[fid]], axis=1).astype(np.float32))
        bi.append(inv_sigma2[k.octave[fid]])
        rp.append(pid.astype(np.int64))
        rk.append(np.full(len(fid), kid, np.int64))
        rf.append(fid.astype(np.int64))
    if not bc:
        z = np.empty(0, np.int64)
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty((0, 3), np.float32), np.empty(0, np.float32),
                z, z, z)
    return (np.concatenate(bc), np.concatenate(bp), np.concatenate(bo),
            np.concatenate(bi).astype(np.float32),
            np.concatenate(rp), np.concatenate(rk), np.concatenate(rf))


def pad_edge_table(e_cam, e_pt, e_obs, e_info, E: int):
    """Place the unpadded columns into fixed-capacity arrays (invalid rows
    flagged false)."""
    n_e = min(len(e_cam), E)
    c = np.zeros(E, np.int32)
    p = np.zeros(E, np.int32)
    o = np.full((E, 3), -1.0, np.float32)
    w = np.ones(E, np.float32)
    v = np.zeros(E, bool)
    c[:n_e] = e_cam[:n_e]
    p[:n_e] = e_pt[:n_e]
    o[:n_e] = e_obs[:n_e]
    w[:n_e] = e_info[:n_e]
    v[:n_e] = True
    return c, p, o, w, v, n_e


def _steady_start(n_features: int, mult: float, lo: int, cap: int) -> int:
    """Bucket starting size that reaches the steady-state shape of a
    full-budget scene on the FIRST call: local-window populations scale
    with the ORB feature budget, so sizing the start from n_features keeps
    bucket-growth recompiles out of the running pipeline (a mid-run grow
    costs a full XLA compile on the mapping worker)."""
    n = max(lo, int(mult * n_features))
    p2 = 1 << (n - 1).bit_length()
    return int(min(cap, p2))


# Online-mode LM chunk schedule for the background human BA: the
# reference protocol's 5 Huber + 10 plain iterations (Optimizer.cc:701-704)
# split into three ~equal device programs, with the worker waiting for each
# before it enqueues the next.  The premise: the device runs one program
# at a time from one stream, so a long solve enqueued whole would hold the
# tracking thread's fused step behind it; splitting bounds that wait.  The
# premise is NOT YET CHECKED ON THE GPU.  Inlier gating re-runs at each
# chunk boundary (each call classifies against the current state before
# its plain phase) — a deviation from the single-dispatch protocol that
# applies ONLY on the online path; offline keeps the reference-exact
# single dispatch.  The short static-mapping programs are not chunked;
# they defer to the tracking thread via TrackingGate (utils/gate.py).
_LM_CHUNKS = ((5, 0), (0, 5), (0, 5))


class _StickyBucket:
    """Grow-only power-of-two padding: each driver compiles at most a couple
    of jit variants per run instead of one per problem size, and never
    recompiles when problems shrink."""

    def __init__(self, lo: int, hi: int):
        self.cur = lo
        self.hi = hi

    def fit(self, n: int) -> int:
        while self.cur < n and self.cur < self.hi:
            self.cur *= 2
        return min(self.cur, self.hi)

class StaticLocalBA:
    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 map_lock=None):
        self.config = config
        self.map = slam_map
        self.profiler = None
        # tracking<->mapping guard: held for graph assembly and write-back,
        # RELEASED during the device solve so the tracking thread is never
        # blocked by an in-flight optimization (reference
        # LocalBundleAdjustment locks the map only around its recovery
        # phase, Optimizer.cc:657-659).  None (tests, offline single
        # thread) degrades to a no-op context.
        self.map_lock = map_lock
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.inv_sigma2 = (1.0 / extractor.sigma2).astype(np.float32)
        dev = config.device
        self.max_cams = 128         # hard ceiling, reference has none
        self.P = dev.max_local_points
        self.E = dev.max_ba_edges
        # start the camera bucket at 2x the configured window: mature maps
        # anchor the window with more fixed observers than max_fixed_kfs
        # (the budget is max_cams - n_local, reference Optimizer.cc takes
        # ALL non-local observers), and the first growth otherwise lands a
        # recompile mid-run
        self._cb = _StickyBucket(
            min(2 * (dev.max_local_kfs + dev.max_fixed_kfs), self.max_cams),
            self.max_cams)
        nf = config.orb.n_features
        self._pb = _StickyBucket(_steady_start(nf, 1.5, 1024, self.P), self.P)
        self._eb = _StickyBucket(_steady_start(nf, 6.0, 4096, self.E), self.E)
        if dev.n_chips > 1:
            from airdos_tpu.parallel.sharded_ba import (
                make_mesh, sharded_local_bundle_adjust)
            self._jit = sharded_local_bundle_adjust(make_mesh(dev.n_chips))
        else:
            self._jit = jax.jit(local_bundle_adjust,
                                static_argnames=("iters1", "iters2"))
        # online: installed by System — defer enqueuing while the tracking
        # thread is inside its per-frame device window (utils/gate.py)
        self.gate = None

    def __call__(self, kf: KeyFrame):
        import contextlib
        lock = self.map_lock if self.map_lock is not None \
            else contextlib.nullcontext()
        with lock:
            problem = self._assemble(kf)
        if problem is None:
            return
        res = self._solve(problem)
        with lock:
            self._write_back(problem, res)

    def _assemble(self, kf: KeyFrame):
        m = self.map
        pt = m.points
        local_ids = [kf.id] + [k for k in kf.ordered_covis
                               if not m.kfs[k].bad][: self.config.device.max_local_kfs - 1]
        local_set = set(local_ids)

        point_ids = collect_window_points(m, local_ids, self.P)
        sel = point_slot_lookup(m, point_ids)
        fixed_ids = find_fixed_observers(
            m, local_set, sel, self.max_cams - len(local_ids),
            "StaticLocalBA")
        fset = set(fixed_ids)

        cam_ids = local_ids + fixed_ids
        cam_index = {kid: i for i, kid in enumerate(cam_ids)}
        n_cam = len(cam_ids)
        if n_cam < 2 or len(point_ids) < 10:
            return

        C = self._cb.fit(n_cam)
        P = self._pb.fit(len(point_ids))
        cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        cam_t = np.zeros((C, 3), np.float32)
        cam_fixed = np.ones(C, bool)
        for kid, i in cam_index.items():
            k = m.kfs[kid]
            cam_R[i] = k.Rcw
            cam_t[i] = k.tcw
            cam_fixed[i] = kid in fset or kid == 0   # KF0 always fixed
        pts = np.zeros((P, 3), np.float32)
        pvalid = np.zeros(P, bool)
        pts[:len(point_ids)] = pt.pos[point_ids]
        pvalid[:len(point_ids)] = True

        ec, ep, eo, ei, ref_p, ref_kf, ref_fid = assemble_edges(
            m, cam_ids, sel, self.inv_sigma2)
        E = self._eb.fit(len(ec))
        if self.config.device.n_chips > 1:
            E = _round_up(E, self.config.device.n_chips)
        e_cam, e_pt, e_obs, e_info, e_valid, n_e = pad_edge_table(
            ec, ep, eo, ei, E)

        return dict(local_ids=local_ids, local_set=local_set,
                    cam_index=cam_index, cam_fixed=cam_fixed,
                    cam_t=cam_t, n_cam=n_cam, point_ids=point_ids,
                    n_e=n_e, ref_p=ref_p, ref_kf=ref_kf,
                    arrays=(cam_R, cam_t, cam_fixed, pts, pvalid,
                            e_cam, e_pt, e_obs, e_info, e_valid))

    def _solve(self, problem):
        (cam_R, cam_t, cam_fixed, pts, pvalid,
         e_cam, e_pt, e_obs, e_info, e_valid) = problem["arrays"]
        with span(self.profiler, "ba.solve"):
            tail = (jnp.asarray(e_cam), jnp.asarray(e_pt),
                    jnp.asarray(e_obs), jnp.asarray(e_info),
                    jnp.asarray(e_valid),
                    self.fx, self.fy, self.cx, self.cy, self.bf)
            R, t, ps = (jnp.asarray(cam_R), jnp.asarray(cam_t),
                        jnp.asarray(pts))
            cfx, pv = jnp.asarray(cam_fixed), jnp.asarray(pvalid)
            gate_wait(self.gate)          # tracking dispatches first
            res = self._jit(R, t, cfx, ps, pv, *tail)
            return jax.device_get(
                (res.R, res.t, res.points, res.edge_inlier))

    def _write_back(self, problem, res):
        m = self.map
        pt = m.points
        R_out, t_out, pts_out, inlier = res
        cam_index = problem["cam_index"]
        cam_fixed = problem["cam_fixed"]
        point_ids = problem["point_ids"]
        n_e = problem["n_e"]
        ref_p, ref_kf = problem["ref_p"], problem["ref_kf"]

        import os
        if os.environ.get("AIRDOS_BA_DEBUG") == "1":
            local_ids, local_set = problem["local_ids"], problem["local_set"]
            demoted = np.nonzero(~inlier[:n_e])[0]
            newest = max(local_ids)
            old_pt = {int(p) for p in point_ids
                      if min(pt.obs[p], default=newest) < newest - 4}
            n_dem_old = int(sum(1 for i in demoted
                                if int(ref_p[i]) in old_pt
                                and int(ref_kf[i]) in local_set))
            dpose = max(float(np.linalg.norm(t_out[i] - problem["cam_t"][i]))
                        for kid, i in cam_index.items() if not cam_fixed[i])
            print(f"[BA kf={local_ids[0]}] cams={problem['n_cam']} "
                  f"pts={len(point_ids)} edges={n_e} demoted={len(demoted)} "
                  f"demoted_old_edges={n_dem_old} max_dpose={dpose:.4f}",
                  flush=True)

        with span(self.profiler, "ba.writeback"):
            for kid, i in cam_index.items():
                # a KF culled while the solve was in flight stays where
                # the culler left it (reference: pKF->isBad() recheck)
                k = m.kfs.get(kid)
                if k is not None and not k.bad and not cam_fixed[i]:
                    k.set_pose(R_out[i], t_out[i])
            # recheck pt.bad like the KF path above: a point culled while
            # the solve was in flight must stay where the culler left it
            alive = ~pt.bad[point_ids]
            pt.pos[point_ids[alive]] = pts_out[:len(point_ids)][alive]
            # erase outlier observations (usually a handful)
            for i in np.nonzero(~inlier[:n_e])[0]:
                if not pt.bad[int(ref_p[i])]:
                    m.erase_observation(int(ref_p[i]), int(ref_kf[i]))
            m.update_points_normal_depth(point_ids[alive])


class Triangulator:
    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 local_mapper, map_lock=None):
        self.config = config
        self.map = slam_map
        self.local_mapper = local_mapper
        # held for assembly + write-back, released during the device
        # solve so the tracking thread never waits on a triangulation
        # dispatch (same discipline as StaticLocalBA above)
        self.map_lock = map_lock
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.scale_factors = np.asarray(extractor.scales, np.float32)
        self.sigma2 = extractor.sigma2
        self.log_scale = float(np.log(config.orb.scale_factor))
        self.n_levels = config.orb.n_levels
        self.n_neighbors = 4     # batched in one dispatch
        # vmap over the neighbor axis -> ONE device dispatch per keyframe
        # (n_levels is unused inside triangulate_pair; all args positional)
        self._jit = jax.jit(
            jax.vmap(triangulate_pair,
                     in_axes=(None,) * 8 + (0,) * 8 + (None,) * 9))
        self.gate = None          # online: see utils/gate.py

    def baseline_ok(self, kf: KeyFrame, nkf: KeyFrame) -> bool:
        """Stereo short-baseline gate: reject neighbors closer than the
        stereo baseline mb = bf/fx (reference LocalMapping.cc:259-266; the
        mono path's baseline/medianDepth < 0.01 ratio is dead in this
        stereo-only fork) — triangulating from a near-zero baseline
        injects pure-noise points."""
        return bool(np.linalg.norm(nkf.Ow - kf.Ow) >= self.bf / self.fx)

    def __call__(self, kf: KeyFrame, n_neighbors: int = None):
        import contextlib
        lock = self.map_lock if self.map_lock is not None \
            else contextlib.nullcontext()
        with lock:
            problem = self._assemble(kf, n_neighbors)
        if problem is None:
            return 0
        neighbors, args = problem
        gate_wait(self.gate)          # tracking dispatches first
        res = self._jit(*args)
        got = jax.device_get((res.valid, res.idx2, res.points))
        with lock:
            return self._write_back(kf, neighbors, got)

    def _assemble(self, kf: KeyFrame, n_neighbors: int = None):
        m = self.map
        K = n_neighbors or self.n_neighbors
        neighbors = []
        for nid in kf.best_covisible(10):
            nkf = m.kfs.get(nid)
            if nkf is None or nkf.bad:
                continue
            if not self.baseline_ok(kf, nkf):
                continue
            neighbors.append(nkf)
            if len(neighbors) == K:
                break
        if not neighbors:
            return None
        # pad the batch by repeating the first neighbor (results discarded)
        batch = neighbors + [neighbors[0]] * (K - len(neighbors))
        free1 = (kf.mp_idx < 0) & kf.valid

        def stack(attr):
            return jnp.asarray(np.stack([getattr(n, attr) for n in batch]))

        free2 = np.stack([(n.mp_idx < 0) & n.valid for n in batch])
        args = (
            jnp.asarray(kf.xy_un), jnp.asarray(kf.octave),
            jnp.asarray(kf.u_right), jnp.asarray(kf.depth),
            jnp.asarray(kf.desc32), jnp.asarray(free1),
            jnp.asarray(kf.Rcw), jnp.asarray(kf.tcw),
            stack("xy_un"), stack("octave"), stack("u_right"), stack("depth"),
            stack("desc32"), jnp.asarray(free2), stack("Rcw"), stack("tcw"),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            jnp.asarray(self.scale_factors), jnp.asarray(self.sigma2),
            self.log_scale, self.n_levels)
        return neighbors, args

    def _write_back(self, kf: KeyFrame, neighbors, got):
        m = self.map
        valid_b, idx2_b, X_b = got
        created_total = 0
        created_pids = []
        if kf.bad:     # culled while the solve was in flight
            return 0
        for b, nkf in enumerate(neighbors):
            if nkf.bad:
                continue
            valid = valid_b[b]
            idx2 = idx2_b[b]
            X = X_b[b]
            f1 = np.nonzero(valid & (kf.mp_idx < 0))[0]
            used2 = set()
            new_f1, new_f2 = [], []
            for fid in f1:
                f2 = int(idx2[fid])
                if f2 in used2 or nkf.mp_idx[f2] >= 0 or kf.mp_idx[fid] >= 0:
                    continue
                used2.add(f2)
                new_f1.append(int(fid))
                new_f2.append(f2)
            if not new_f1:
                continue
            fids = np.asarray(new_f1)
            pids = m.create_points(kf, fids, X[fids])   # one batched alloc
            for pid, f2 in zip(pids, new_f2):
                m.add_observation(int(pid), nkf, f2)
            created_pids.extend(int(p) for p in pids)
            self.local_mapper.recent_points.extend(int(p) for p in pids)
            created_total += len(new_f1)
        m.update_point_descriptors(created_pids)
        m.update_points_normal_depth(created_pids)
        return created_total


class Fuser:
    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 map_lock=None):
        self.config = config
        self.map = slam_map
        # held for assembly + write-back, released during the device
        # solve (see StaticLocalBA); _fuse_into (loop-closing path) is
        # always called with the lock already held and never takes it
        self.map_lock = map_lock
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.width, self.height = cam.width, cam.height
        self.scale_factors = np.asarray(extractor.scales, np.float32)
        self.sigma2 = extractor.sigma2
        self.log_scale = float(np.log(config.orb.scale_factor))
        self.n_levels = config.orb.n_levels
        self.P = config.device.max_local_points
        self._jit = jax.jit(fuse_candidates, static_argnames=("n_levels",))
        # BOTH fuse directions in one dispatch: vmap over target keyframes
        # with a shared union candidate table and a PER-TARGET valid mask
        # (direction-1 rows see the current KF's points, the direction-2
        # row sees the neighbors' points) — one dispatch instead of one per
        # direction
        self._jit_batch = jax.jit(
            jax.vmap(fuse_candidates,
                     in_axes=(None, None, 0, None, None, None)
                     + (0,) * 8 + (None,) * 12))
        self.max_targets = 8
        self._pb = _StickyBucket(
            _steady_start(config.orb.n_features, 1.5, 1024, self.P), self.P)
        self.n_slots = config.device.max_keypoints
        self._warmed = set()
        self.gate = None          # online: see utils/gate.py

    def warmup(self, n_points: int):
        """Compile the single-target fuse program (the SearchAndFuse /
        loop-closing path) at its bucket shape, OUTSIDE any lock.  The
        first loop closure otherwise pays this compile while correct()
        holds the map lock, stalling the tracking thread for seconds."""
        P = self._pb.fit(max(1, min(n_points, self.P)))
        if P in self._warmed:
            return
        self._warmed.add(P)
        N = self.n_slots
        z3 = jnp.zeros((P, 3), jnp.float32)
        res = self._jit(z3, jnp.zeros((P, 8), jnp.uint32),
                        jnp.zeros(P, bool), z3,
                        jnp.zeros(P, jnp.float32), jnp.zeros(P, jnp.float32),
                        jnp.eye(3, dtype=jnp.float32),
                        jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
                        jnp.zeros((N, 2), jnp.float32),
                        jnp.zeros(N, jnp.float32),
                        jnp.zeros(N, jnp.int32),
                        jnp.zeros((N, 8), jnp.uint32), jnp.zeros(N, bool),
                        self.fx, self.fy, self.cx, self.cy, self.bf,
                        self.width, self.height,
                        jnp.asarray(self.scale_factors),
                        jnp.asarray(self.sigma2),
                        self.log_scale, self.n_levels)
        np.asarray(res.feat_idx)          # block until compiled + run

    def _fuse_into(self, point_ids: List[int], target: KeyFrame,
                   prefer_candidates: bool = False):
        """prefer_candidates: conflict resolution keeps the candidate point
        (SearchAndFuse semantics, reference LoopClosing.cc:587) instead of
        the more-observed one."""
        m = self.map
        pt = m.points
        point_ids = [p for p in point_ids if not pt.bad[p]
                     and target.id not in pt.obs[p]][: self.P]
        if not point_ids:
            return
        n = len(point_ids)
        P = self._pb.fit(n)
        ids = np.asarray(point_ids)
        xw = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        valid = np.zeros(P, bool)
        xw[:n] = pt.pos[ids]
        desc[:n] = pt.desc32[ids]
        normal[:n] = pt.normal[ids]
        mind[:n] = pt.min_dist[ids]
        maxd[:n] = pt.max_dist[ids]
        valid[:n] = True
        res = self._jit(jnp.asarray(xw), jnp.asarray(desc), jnp.asarray(valid),
                        jnp.asarray(normal), jnp.asarray(maxd), jnp.asarray(mind),
                        jnp.asarray(target.Rcw), jnp.asarray(target.tcw),
                        jnp.asarray(target.Ow),
                        jnp.asarray(target.xy_un), jnp.asarray(target.u_right),
                        jnp.asarray(target.octave), jnp.asarray(target.desc32),
                        jnp.asarray(target.valid),
                        self.fx, self.fy, self.cx, self.cy, self.bf,
                        self.width, self.height,
                        jnp.asarray(self.scale_factors), jnp.asarray(self.sigma2),
                        self.log_scale, self.n_levels)
        feat_idx = np.asarray(res.feat_idx)
        touched = []
        for i in np.nonzero(feat_idx[:n] >= 0)[0]:
            fid = int(feat_idx[i])
            pid = int(ids[i])
            if pt.bad[pid]:
                continue
            existing = int(target.mp_idx[fid])
            if existing >= 0 and not pt.bad[existing]:
                if existing == pid:
                    continue
                # merge: candidate wins in SearchAndFuse mode, else the
                # point with more observations survives
                if prefer_candidates or pt.n_obs[pid] >= pt.n_obs[existing]:
                    m.replace_point(existing, pid)
                    touched.append(pid)
                else:
                    m.replace_point(pid, existing)
                    touched.append(existing)
            else:
                m.add_observation(pid, target, fid)
                touched.append(pid)
        m.update_point_descriptors(touched)
        m.update_points_normal_depth(touched)

    def _assemble_neighborhood(self, kf: KeyFrame, targets: List[KeyFrame]):
        m = self.map
        pt = m.points
        kfp = kf.mp_idx[kf.mp_idx >= 0]
        kf_points = np.unique(kfp)
        if targets:
            allp = np.concatenate([t.mp_idx for t in targets])
            nb_points = np.unique(allp[allp >= 0])
        else:
            nb_points = np.empty(0, kf_points.dtype)
        union = np.union1d(kf_points, nb_points)
        union = union[~pt.bad[union]][: self.P]
        if union.size == 0 or not targets:
            return None
        n = len(union)
        P = self._pb.fit(n)
        ids = union
        xw = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        xw[:n] = pt.pos[ids]
        desc[:n] = pt.desc32[ids]
        normal[:n] = pt.normal[ids]
        mind[:n] = pt.min_dist[ids]
        maxd[:n] = pt.max_dist[ids]

        # pad the target batch to a FIXED size so the vmapped program
        # compiles once; row B is the current KF (direction 2); padded
        # rows get valid=False candidates AND features
        B = self.max_targets
        n_t = len(targets)
        rows_kf = targets + [targets[0]] * (B - n_t) + [kf]
        in_kf = np.isin(union, kf_points, assume_unique=True)
        in_nb = np.isin(union, nb_points, assume_unique=True)
        valid = np.zeros((B + 1, P), bool)
        valid[:n_t, :n] = in_kf[None, :]
        valid[B, :n] = in_nb

        def stack(fn, zero_pad=False):
            rows = [fn(t) for t in rows_kf]
            if zero_pad:
                for b in range(n_t, B):
                    rows[b] = np.zeros_like(rows[b])
            return jnp.asarray(np.stack(rows))

        args = (
            jnp.asarray(xw), jnp.asarray(desc), jnp.asarray(valid),
            jnp.asarray(normal), jnp.asarray(maxd), jnp.asarray(mind),
            stack(lambda t: t.Rcw), stack(lambda t: t.tcw),
            stack(lambda t: t.Ow),
            stack(lambda t: t.xy_un), stack(lambda t: t.u_right),
            stack(lambda t: t.octave), stack(lambda t: t.desc32),
            stack(lambda t: t.valid, zero_pad=True),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            jnp.asarray(self.scale_factors), jnp.asarray(self.sigma2),
            self.log_scale, self.n_levels, 3.0)
        return ids, n, args

    def _write_back_neighborhood(self, kf: KeyFrame, targets, ids, n,
                                 feat_idx_b):
        m = self.map
        pt = m.points
        B = self.max_targets
        touched = []
        for b, target in list(enumerate(targets)) + [(B, kf)]:
            if target.bad:     # culled while the solve was in flight
                continue
            feat_idx = feat_idx_b[b]
            for i in np.nonzero(feat_idx[:n] >= 0)[0]:
                fid = int(feat_idx[i])
                pid = int(ids[i])
                if pt.bad[pid] or target.id in pt.obs[pid]:
                    continue
                existing = int(target.mp_idx[fid])
                if existing >= 0 and not pt.bad[existing]:
                    if pt.n_obs[existing] > pt.n_obs[pid]:
                        m.replace_point(pid, existing)
                        touched.append(existing)
                    else:
                        m.replace_point(existing, pid)
                        touched.append(pid)
                else:
                    m.add_observation(pid, target, fid)
                    touched.append(pid)
        m.update_point_descriptors(touched)
        m.update_points_normal_depth(touched)

    def __call__(self, kf: KeyFrame, n_neighbors: int = 10):
        import contextlib
        m = self.map
        lock = self.map_lock if self.map_lock is not None \
            else contextlib.nullcontext()
        with lock:
            targets = []
            for nid in kf.best_covisible(n_neighbors):
                nkf = m.kfs.get(nid)
                if nkf is None or nkf.bad:
                    continue
                targets.append(nkf)
                for nid2 in nkf.best_covisible(5):
                    n2 = m.kfs.get(nid2)
                    if n2 is not None and not n2.bad and n2.id != kf.id \
                            and n2 not in targets:
                        targets.append(n2)
            targets = targets[: self.max_targets]
            # both directions (kf's points into neighbors + neighbors'
            # points into kf) in one dispatch
            problem = self._assemble_neighborhood(kf, targets)
        if problem is None:
            return
        ids, n, args = problem
        # lock released for the device work
        gate_wait(self.gate)          # tracking dispatches first
        res = self._jit_batch(*args)
        feat_idx_b = np.asarray(res.feat_idx)
        with lock:
            self._write_back_neighborhood(kf, targets, ids, n, feat_idx_b)
            # refresh (batched: this touches every point of the KF)
            kf_pids = [int(p) for p in kf.mp_idx[kf.mp_idx >= 0]
                       if not m.points.bad[int(p)]]
            m.update_point_descriptors(kf_pids)
            m.update_points_normal_depth(kf_pids)
            m.update_connections(kf)


def select_window_trajectories(trajectories, window_ids, max_trajectories):
    """Human trajectories observed in the local window, long enough for BA
    (> TH_LONG_TRAJECTORY poses) — MOST RECENTLY OBSERVED first, so with
    more than max_trajectories humans the currently-visible tracks win over
    stale ones (reference collects the local KFs' observed trajectories,
    Optimizer.cc:1500-1538; dict order would let the oldest tracks win)."""
    cands = []
    for tid, traj in trajectories.items():
        if len(traj) <= TH_LONG_TRAJECTORY:
            continue
        window_poses = [hp.kf_id for hp in traj.poses
                        if hp.kf_id in window_ids]
        if window_poses:
            cands.append((max(window_poses), traj))
    cands.sort(key=lambda c: -c[0])
    return [traj for _, traj in cands[: max_trajectories]]


class HumanLocalBA:
    """Driver for the dynamic human-trajectory BA
    (Optimizer::LocalBundleAdjustmentHumanTrajactory protocol): selects the
    covisibility window + long trajectories whose poses reference local/fixed
    KFs, runs the device solver, writes back KF poses, point positions,
    joint positions, limb lengths, motion models, and the
    bIsLost / bIsBad / bOptimized outlier flags."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 map_lock=None):
        from airdos_tpu.solvers.human_ba import human_bundle_adjust
        self.config = config
        self.map = slam_map
        # same discipline as StaticLocalBA: the lock is held for graph
        # assembly and write-back and RELEASED during the device solve.
        # The reference guards every optimizer with Map::mMutexMapUpdate
        # (Map.h:136) and never runs human BA concurrently with mapping
        # (LocalMapping.cc:88-93 disables it online); here the lock makes
        # the online tracking-thread human BA sound against the mapping
        # worker's erase_observation/set_pose/culling.
        self.map_lock = map_lock
        self._thread = None        # async runner (online mode)
        self._error = None         # exception raised inside the runner
        self.n_runs = 0            # completed BA passes (write-back done)
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.inv_sigma2 = (1.0 / extractor.sigma2).astype(np.float32)
        dev = config.device
        self.max_cams = 128
        self._cb = _StickyBucket(
            min(2 * (dev.max_local_kfs + dev.max_fixed_kfs), self.max_cams),
            self.max_cams)
        self.P = dev.max_local_points
        self.E = dev.max_ba_edges
        self.T = dev.max_trajectories
        self.L = dev.max_trajectory_len
        # the reduced dense system is O((T*L*42)^3) to solve — padding to
        # the configured maxima regardless of the actual window wastes
        # ~(16/8)^3 = 8x solve FLOPs in typical windows; grow-only buckets
        # keep shapes sticky (bounded recompiles) while sizing to demand.
        # Starting at min(8, cap) reaches the steady-state shape of a
        # full crowd scene on the FIRST call, so no recompile lands inside
        # a timed/real-time stretch; scenes with smaller configured caps
        # start (and stay) at their cap
        self._tb = _StickyBucket(min(8, self.T), self.T)
        self._lb = _StickyBucket(min(8, self.L), self.L)
        if dev.n_chips > 1:
            # pad the static edge capacity up to a mesh multiple instead
            # of silently falling back to single-chip
            self.E = _round_up(self.E, dev.n_chips)
            from airdos_tpu.parallel.sharded_ba import (
                make_mesh, sharded_human_bundle_adjust)
            self._jit = sharded_human_bundle_adjust(make_mesh(dev.n_chips))
            self._chunked = False
        else:
            self._jit = jax.jit(human_bundle_adjust,
                                static_argnames=("iters1", "iters2"))
            # online: the background solve yields the device to the
            # tracking thread between bounded chunks (see _LM_CHUNKS)
            self._chunked = not config.system.is_offline
        self.gate = None          # online: see utils/gate.py

    def __call__(self, slam_map: SlamMap, current_kf_id: int):
        import contextlib
        lock = self.map_lock if self.map_lock is not None \
            else contextlib.nullcontext()
        with lock:
            problem = self._assemble(current_kf_id)
        if problem is None:
            return
        res = self._solve(problem)           # lock released for the solve
        with lock:
            self._write_back(problem, res)
        self.n_runs += 1

    def launch(self, current_kf_id: int):
        """Run one human BA in a background thread (online mode), so the
        tracking loop never blocks on the dense reduced solve — the same
        overlap the reference gets for global BA from its GBA thread
        (LoopClosing.cc:579).  At most one in flight: if the previous BA
        is still solving, this cadence tick is skipped (returns False)."""
        import threading
        if self._thread is not None and self._thread.is_alive():
            return False

        def _run():
            try:
                self.__call__(self.map, current_kf_id)
            except Exception as e:          # surfaced at the next join()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="human-ba")
        self._thread.start()
        return True

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _assemble(self, current_kf_id: int):
        m = self.map
        pt = m.points
        kf = m.kfs.get(current_kf_id)
        if kf is None:
            return

        opt = self.config.optimizer
        dev = self.config.device
        local_ids = [kf.id] + [k for k in kf.ordered_covis
                               if not m.kfs[k].bad][: dev.max_local_kfs - 1]
        local_set = set(local_ids)

        # local points + ALL outside observers anchoring the problem
        # (see StaticLocalBA) — vectorized via the feature->point tables
        point_ids = collect_window_points(m, local_ids, self.P)
        sel = point_slot_lookup(m, point_ids)
        fixed_ids = find_fixed_observers(
            m, local_set, sel, self.max_cams - len(local_ids),
            "HumanLocalBA")
        fset = set(fixed_ids)

        cam_ids = local_ids + fixed_ids
        cam_index = {kid: i for i, kid in enumerate(cam_ids)}
        window_ids = local_set | fset

        trajs = select_window_trajectories(m.trajectories, window_ids,
                                           self.T)
        if not trajs:
            return

        # pose windows first, so T/L pad to the ACTUAL problem (bucketed)
        fast = self.config.optimizer.use_fast_human_ba
        windows = []
        for traj in trajs:
            if fast:
                # Fast variant: the ENTIRE trajectory enters the graph
                # (Optimizer::LocalBundleAdjustmentHumanTrajactoryFast,
                # Optimizer.cc:736-1493), capped only by the padded window
                win = list(range(len(traj.poses)))[-self.L:]
            else:
                # windowed variant: last L poses whose ref KF is in the
                # window (Optimizer.cc:1496-2224)
                win = [i for i, hp in enumerate(traj.poses)
                       if hp.kf_id in window_ids][-self.L:]
            windows.append(win)

        C, P, E = self._cb.fit(len(cam_ids)), self.P, self.E
        T = self._tb.fit(len(trajs))
        L = self._lb.fit(max((len(s) for s in windows), default=2))
        cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        cam_t = np.zeros((C, 3), np.float32)
        cam_fixed = np.ones(C, bool)
        for kid, i in cam_index.items():
            k = m.kfs[kid]
            cam_R[i] = k.Rcw
            cam_t[i] = k.tcw
            cam_fixed[i] = (kid in fset) or kid == 0

        pts = np.zeros((P, 3), np.float32)
        pvalid = np.zeros(P, bool)
        pts[:len(point_ids)] = pt.pos[point_ids]
        pvalid[:len(point_ids)] = True

        ec, ep, eo, ei, ref_p, ref_kf, _ = assemble_edges(
            m, cam_ids, sel, self.inv_sigma2)
        es_cam, es_pt, es_obs, es_info, es_valid, n_e = pad_edge_table(
            ec, ep, eo, ei, E)

        # ---- human arrays --------------------------------------------
        joints = np.zeros((T, L, N_PARTS, 3), np.float32)
        joint_exists = np.zeros((T, L, N_PARTS), bool)
        jo_cam = np.full((T, L), -1, np.int32)
        jo_obs = np.full((T, L, N_PARTS, 3), -1.0, np.float32)
        jo_valid = np.zeros((T, L, N_PARTS), bool)
        seg_len = np.zeros((T, N_PARTS), np.float32)
        seg_free = np.zeros((T, N_PARTS), bool)
        seg_edge_valid = np.zeros((T, L, N_PARTS), bool)
        mot_R = np.tile(np.eye(3, dtype=np.float32), (T, 1, 1))
        mot_t = np.zeros((T, 3), np.float32)
        traj_valid = np.zeros(T, bool)
        pose_dt = np.full((T, L), 1.0, np.float32)
        motion_edge_valid = np.zeros((T, L, 5), bool)
        pose_windows = windows   # per t: pose indices into traj.poses

        for t, traj in enumerate(trajs):
            win = pose_windows[t]
            if len(win) < 2:
                continue
            traj_valid[t] = True
            mot_R[t] = traj.motion_R
            mot_t[t] = traj.motion_t
            seg_len[t] = traj.segment_len
            # bad&unoptimized segments stay fixed (Optimizer.cc:1744-1760)
            seg_free[t] = ~(traj.segment_bad & ~traj.segment_optimized)
            for li, pi in enumerate(win):
                hp = traj.poses[pi]
                joints[t, li] = hp.joints_w[:N_PARTS]
                joint_exists[t, li] = True
                ci = cam_index.get(hp.kf_id)
                if ci is not None and hp.in_keyframe and hp.obs_uvd is not None:
                    jo_cam[t, li] = ci
                    jo_obs[t, li, :, 0] = hp.obs_uvd[:N_PARTS, 0]
                    jo_obs[t, li, :, 1] = hp.obs_uvd[:N_PARTS, 1]
                    jo_obs[t, li, :, 2] = hp.obs_uvd[:N_PARTS, 2]
                    jo_valid[t, li] = ~hp.bad[:N_PARTS]
                seg_edge_valid[t, li] = True
                if li + 1 < len(win):
                    dt = traj.poses[win[li + 1]].timestamp - hp.timestamp
                    pose_dt[t, li] = max(dt, 1e-3)
                    motion_edge_valid[t, li] = True

        if not traj_valid.any():
            return

        return dict(
            cam_index=cam_index, cam_fixed=cam_fixed, point_ids=point_ids,
            n_e=n_e, ref_p=ref_p, ref_kf=ref_kf, trajs=trajs,
            traj_valid=traj_valid, pose_windows=pose_windows,
            seg_edge_valid=seg_edge_valid, jo_valid=jo_valid,
            motion_edge_valid=motion_edge_valid,
            arrays=(cam_R, cam_t, cam_fixed, pts, pvalid,
                    es_cam, es_pt, es_obs, es_info, es_valid,
                    joints, joint_exists, jo_cam, jo_obs, jo_valid,
                    seg_len, seg_free, seg_edge_valid,
                    mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid))

    def _solve(self, problem):
        opt = self.config.optimizer
        (cam_R, cam_t, cam_fixed, pts, pvalid,
         es_cam, es_pt, es_obs, es_info, es_valid,
         joints, joint_exists, jo_cam, jo_obs, jo_valid,
         seg_len, seg_free, seg_edge_valid,
         mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid) = \
            problem["arrays"]
        state = [jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(pts),
                 jnp.asarray(joints), jnp.asarray(seg_len),
                 jnp.asarray(mot_R), jnp.asarray(mot_t)]
        consts = (jnp.asarray(cam_fixed), jnp.asarray(pvalid),
                  jnp.asarray(es_cam), jnp.asarray(es_pt),
                  jnp.asarray(es_obs), jnp.asarray(es_info),
                  jnp.asarray(es_valid), jnp.asarray(joint_exists),
                  jnp.asarray(jo_cam), jnp.asarray(jo_obs),
                  jnp.asarray(jo_valid), jnp.asarray(seg_free),
                  jnp.asarray(seg_edge_valid), jnp.asarray(traj_valid),
                  jnp.asarray(pose_dt), jnp.asarray(motion_edge_valid))

        def call(st, **iters):
            camR, camt, p, j, s, mR, mt = st
            (cfx, pv, ec, ep, eo, ei, ev, je, jc, jo, jv, sf, sev, tv,
             pdt, mev) = consts
            return self._jit(
                camR, camt, cfx, p, pv, ec, ep, eo, ei, ev,
                j, je, jc, jo, jv, s, sf, sev, mR, mt, tv, pdt, mev,
                opt.sigma_static, opt.sigma_human, opt.sigma_rigidity,
                opt.sigma_motion,
                opt.th_huber_motion, opt.th_ransac_motion,
                opt.th_ransac_rigidity,
                self.fx, self.fy, self.cx, self.cy, self.bf,
                opt.is_huber, **iters)

        if not self._chunked:
            gate_wait(self.gate)      # tracking dispatches first
            res = call(state)
        else:
            res = None
            for i1, i2 in _LM_CHUNKS:
                if res is not None:
                    jax.block_until_ready(res)   # bound the in-flight program
                    state = [res.cam_R, res.cam_t, res.points, res.joints,
                             res.seg_len, res.mot_R, res.mot_t]
                gate_wait(self.gate)  # tracking dispatches first
                res = call(state, iters1=i1, iters2=i2)
        # one batched pytree download instead of one transfer per field
        return jax.device_get(res)

    def _write_back(self, problem, res):
        m = self.map
        pt = m.points
        cam_index = problem["cam_index"]
        cam_fixed = problem["cam_fixed"]
        point_ids = problem["point_ids"]
        n_e = problem["n_e"]
        ref_p, ref_kf = problem["ref_p"], problem["ref_kf"]
        trajs = problem["trajs"]
        traj_valid = problem["traj_valid"]
        pose_windows = problem["pose_windows"]
        seg_edge_valid = problem["seg_edge_valid"]
        jo_valid = problem["jo_valid"]
        motion_edge_valid = problem["motion_edge_valid"]
        camR_o = np.asarray(res.cam_R)
        camt_o = np.asarray(res.cam_t)
        for kid, i in cam_index.items():
            # a KF culled while the solve was in flight stays where the
            # culler left it (reference: pKF->isBad() recheck)
            k = m.kfs.get(kid)
            if k is not None and not k.bad and not cam_fixed[i]:
                k.set_pose(camR_o[i], camt_o[i])
        pts_o = np.asarray(res.points)
        alive = ~pt.bad[point_ids]
        pt.pos[point_ids[alive]] = pts_o[:len(point_ids)][alive]
        s_in = np.asarray(res.static_inlier)
        for i in np.nonzero(~s_in[:n_e])[0]:
            if not pt.bad[int(ref_p[i])]:
                m.erase_observation(int(ref_p[i]), int(ref_kf[i]))
        m.update_points_normal_depth(point_ids[alive])

        joints_o = np.asarray(res.joints)
        seg_o = np.asarray(res.seg_len)
        motR_o = np.asarray(res.mot_R)
        mott_o = np.asarray(res.mot_t)
        key_in = np.asarray(res.key_inlier)
        rig_in = np.asarray(res.rigid_inlier)
        mot_in = np.asarray(res.motion_inlier)
        torso = np.asarray([1, 2, 5, 11, 8])
        body1 = np.asarray(BODY1)
        body2 = np.asarray(BODY2)
        rig_bad = seg_edge_valid & ~rig_in       # [T, L, S]
        rig_ok = seg_edge_valid & rig_in
        proj_bad = jo_valid & ~key_in
        # motion edges connect pose l -> l+1, so the solver reports L-1 rows
        mot_bad = motion_edge_valid[:, :mot_in.shape[1]] & ~mot_in  # [T,L-1,5]
        for t, traj in enumerate(trajs):
            if not traj_valid[t]:
                continue
            win = pose_windows[t]
            traj.motion_R = motR_o[t]
            traj.motion_t = mott_o[t]
            traj.segment_len = seg_o[t]
            traj.optimized = True
            self.map.optimized_track_ids.add(traj.track_id)
            # rigidity outliers: segment bIsBad whenever any window pose
            # broke it, bOptimized whenever any window pose passed
            traj.segment_bad |= rig_bad[t, :len(win)].any(axis=0)
            traj.segment_optimized |= rig_ok[t, :len(win)].any(axis=0)
            for li, pi in enumerate(win):
                hp = traj.poses[pi]
                hp.joints_w[:N_PARTS] = joints_o[t, li]
                hp.optimized[:N_PARTS] = True
                # both-bad rigidity endpoints become bIsBad joints
                first_bad = np.zeros(18, bool)
                second_bad = np.zeros(18, bool)
                first_bad[body1[rig_bad[t, li]]] = True
                second_bad[body2[rig_bad[t, li]]] = True
                hp.bad[:18] |= first_bad & second_bad
                # projection outliers -> bIsBad
                hp.bad[:N_PARTS] |= proj_bad[t, li]
                # motion outliers -> bIsLost on the FIRST pose's joint
                if li < mot_bad.shape[1]:
                    mb = mot_bad[t, li]
                    hp.lost[torso[mb]] = True
                    traj.bad_count += int(mb.sum())


class GlobalBA:
    """Full-map bundle adjustment (reference: Optimizer::GlobalBundleAdjustemnt
    + LoopClosing::RunGlobalBundleAdjustment, Optimizer.cc:52-230,
    LoopClosing.cc:645-749): EVERY keyframe (KF0 fixed) and EVERY live map
    point — the problem is sized to the actual map through grow-only buckets
    (matrix-free Schur+PCG device program, O(edges) memory), not truncated."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 max_kfs: int = 4096, max_points: int = 1 << 20,
                 max_edges: int = 1 << 22):
        from airdos_tpu.solvers.global_ba import global_bundle_adjust
        self.config = config
        self.map = slam_map
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.inv_sigma2 = (1.0 / extractor.sigma2).astype(np.float32)
        self.max_kfs = max_kfs
        self.max_points = max_points
        self.max_edges = max_edges
        self._cb = _StickyBucket(16, max_kfs)
        self._pb = _StickyBucket(1024, max_points)
        self._eb = _StickyBucket(4096, max_edges)
        self._n_chips = config.device.n_chips
        self.gate = None          # online: see utils/gate.py
        if self._n_chips > 1:
            from airdos_tpu.parallel.sharded_ba import (
                make_mesh, sharded_global_bundle_adjust)
            self._mesh = make_mesh(self._n_chips)
        else:
            self._jit = jax.jit(global_bundle_adjust,
                                static_argnames=("iters1", "iters2",
                                                 "cg_iters"))

    def __call__(self, n_iters: int = 20, abort=None):
        """Synchronous full GBA: assemble -> chunked abortable solve ->
        write-back (with propagation to KFs/points created meanwhile)."""
        problem = self._assemble()
        if problem is None:
            return
        out = self._solve(problem, n_iters, abort)
        if out is None:       # aborted before the first chunk finished
            return
        self._write_back(problem, out)

    # ------------------------------------------------------- async runner
    def launch(self, map_lock, n_iters: int = 20):
        """Run GBA in a background thread like the reference's
        RunGlobalBundleAdjustment thread (LoopClosing.cc:579,645-749):
        assembly and write-back hold the map lock briefly; the device solve
        runs unlocked in abortable chunks.  A new launch aborts any running
        one first (reference LoopClosing.cc:435-446 mbStopGBA)."""
        import threading
        # abort WITHOUT joining: the caller typically holds map_lock
        # (CorrectLoop), and the old thread may be blocked acquiring it
        # for its write-back — joining here would deadlock.  The aborted
        # thread re-checks its flag after every lock acquisition and
        # exits without touching the map.
        self.interrupt(wait=False)
        self._abort = threading.Event()

        def body(abort):
            with map_lock:
                if abort.is_set():
                    return
                problem = self._assemble()
            if problem is None:
                return
            out = self._solve(problem, n_iters, abort)
            if out is None or abort.is_set():
                return
            with map_lock:
                if abort.is_set():
                    return
                self._write_back(problem, out)

        self._thread = threading.Thread(target=body, args=(self._abort,),
                                        daemon=True, name="global-ba")
        self._old_threads = [t for t in getattr(self, "_old_threads", [])
                             if t.is_alive()]
        self._thread.start()

    def interrupt(self, wait: bool = True):
        """Abort a running background GBA (and optionally wait for it)."""
        th = getattr(self, "_thread", None)
        if th is not None and th.is_alive():
            self._abort.set()
            if wait:
                th.join()
            else:
                self._old_threads = getattr(self, "_old_threads", []) + [th]
        self._thread = None

    def join(self):
        for th in getattr(self, "_old_threads", []) + \
                ([self._thread] if getattr(self, "_thread", None) else []):
            th.join()
        self._thread = None
        self._old_threads = []

    # ------------------------------------------------------------ phases
    def _assemble(self):
        m = self.map
        pt = m.points
        kfs = sorted((k for k in m.kfs.values() if not k.bad),
                     key=lambda k: k.id)
        if len(kfs) < 2:
            return None
        if len(kfs) > self.max_kfs:
            warnings.warn(f"GlobalBA: map has {len(kfs)} keyframes, above "
                          f"the {self.max_kfs} budget; truncating")
            kfs = kfs[: self.max_kfs]
        cam_index = {k.id: i for i, k in enumerate(kfs)}
        point_ids = np.asarray(pt.live_ids(),
                               dtype=np.int64)[: self.max_points]
        if len(point_ids) < 10:
            return None
        C = self._cb.fit(len(kfs))
        P = self._pb.fit(len(point_ids))

        cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        cam_t = np.zeros((C, 3), np.float32)
        cam_fixed = np.ones(C, bool)
        for k in kfs:
            i = cam_index[k.id]
            cam_R[i] = k.Rcw
            cam_t[i] = k.tcw
            cam_fixed[i] = (k.id == 0)
        pts = np.zeros((P, 3), np.float32)
        pvalid = np.zeros(P, bool)
        pts[:len(point_ids)] = pt.pos[point_ids]
        pvalid[:len(point_ids)] = True

        sel = point_slot_lookup(m, point_ids)
        ec, ep, eo, ei, _, _, _ = assemble_edges(
            m, [k.id for k in kfs], sel, self.inv_sigma2)
        E = self._eb.fit(len(ec))
        if self._n_chips > 1:
            E = _round_up(E, self._n_chips)
        e_cam, e_pt, e_obs, e_info, e_valid, _ = pad_edge_table(
            ec, ep, eo, ei, E)

        return dict(cam_index=cam_index, point_ids=point_ids,
                    cam_R0=cam_R.copy(), cam_t0=cam_t.copy(),
                    arrays=(cam_R, cam_t, cam_fixed, pts, pvalid,
                            e_cam, e_pt, e_obs, e_info, e_valid))

    def _solve(self, problem, n_iters: int = 20, abort=None):
        """Chunked device solve: ~5 LM iterations per dispatch with an
        abort check between chunks (the reference's mbStopGBA is polled
        between g2o iterations, Optimizer.cc:121-129).  State stays on
        device between chunks — no extra transfers."""
        (cam_R, cam_t, cam_fixed, pts, pvalid,
         e_cam, e_pt, e_obs, e_info, e_valid) = problem["arrays"]
        args_tail = (jnp.asarray(e_cam), jnp.asarray(e_pt),
                     jnp.asarray(e_obs), jnp.asarray(e_info),
                     jnp.asarray(e_valid),
                     self.fx, self.fy, self.cx, self.cy, self.bf)
        chunk = 5
        n_chunks = max(1, -(-n_iters // chunk))
        R, t, ps = jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(pts)
        cfx = jnp.asarray(cam_fixed)
        pv = jnp.asarray(pvalid)
        res = None
        for ci in range(n_chunks):
            if abort is not None and abort.is_set():
                break
            i1 = chunk // 2 if ci == 0 else 0    # Huber phase only first
            i2 = chunk - i1
            gate_wait(self.gate)      # tracking dispatches first
            res = self._chunk_fn(i1, i2)(R, t, cfx, ps, pv, *args_tail)
            R, t, ps = res.R, res.t, res.points
            # retire the chunk before enqueuing the next: JAX dispatches
            # eagerly, so without this every chunk stacks up in the device
            # FIFO at once — the abort check above never fires mid-solve
            # and the tracking thread queues behind the WHOLE solve
            jax.block_until_ready(res)
        return res

    def _chunk_fn(self, i1: int, i2: int, cg_iters: int = 48):
        """One solver dispatch covering i1 Huber + i2 plain LM iterations.
        Both the single-chip and the sharded path solve in these chunks so
        a pending abort (mbStopGBA, Optimizer.cc:121-129) can interrupt a
        multi-chip GBA between dispatches; compiled variants are cached
        per (i1, i2)."""
        key = (i1, i2, cg_iters)
        cache = getattr(self, "_chunk_cache", None)
        if cache is None:
            cache = self._chunk_cache = {}
        fn = cache.get(key)
        if fn is None:
            if self._n_chips > 1:
                from airdos_tpu.parallel.sharded_ba import \
                    sharded_global_bundle_adjust
                fn = sharded_global_bundle_adjust(
                    self._mesh, iters1=i1, iters2=i2, cg_iters=cg_iters)
            else:
                from functools import partial
                fn = partial(self._jit, iters1=i1, iters2=i2,
                             cg_iters=cg_iters)
            cache[key] = fn
        return fn

    def _write_back(self, problem, res):
        """Write solved poses/points; propagate the correction to
        keyframes and points created while the solve ran (reference
        LoopClosing.cc:682-743: spanning-tree walk with mTcwBefGBA)."""
        m = self.map
        pt = m.points
        cam_index = problem["cam_index"]
        point_ids = problem["point_ids"]
        # one batched download instead of one transfer per leaf
        R_out, t_out, pts_out = jax.device_get((res.R, res.t, res.points))
        R0 = problem["cam_R0"]
        t0 = problem["cam_t0"]

        new_pose = {}        # kf_id -> (Rcw, tcw) after correction
        old_pose = {}        # kf_id -> (Rcw, tcw) before correction
        for kid, i in cam_index.items():
            old_pose[kid] = (R0[i], t0[i])
            new_pose[kid] = (R_out[i], t_out[i])
        # KFs created during the solve: correct relative to their parent
        # (children have larger ids than parents, so increasing-id order
        # guarantees the parent is already corrected)
        for k in sorted((k for k in m.kfs.values() if not k.bad),
                        key=lambda k: k.id):
            if k.id in new_pose:
                continue
            old_pose[k.id] = (k.Rcw.copy(), k.tcw.copy())
            par = k.parent
            if par is None or par not in new_pose or par not in old_pose:
                new_pose[k.id] = (k.Rcw.copy(), k.tcw.copy())
                continue
            Rp_o, tp_o = old_pose[par]
            Rp_n, tp_n = new_pose[par]
            # Tcp = Tcw_old * Twp_old ; Tcw_new = Tcp * Tpw_new
            Rcp = k.Rcw @ Rp_o.T
            tcp = k.tcw - Rcp @ tp_o
            new_pose[k.id] = (Rcp @ Rp_n, Rcp @ tp_n + tcp)
        for k in m.kfs.values():
            if k.bad or k.id not in new_pose or k.id == 0:
                continue
            Rn, tn = new_pose[k.id]
            k.set_pose(Rn, tn)
        pt.pos[point_ids] = pts_out[:len(point_ids)]
        # points created during the solve: transform via their ref KF
        solved = set(point_ids)
        extra = [int(p) for p in pt.live_ids() if int(p) not in solved]
        for p in extra:
            ref = int(pt.ref_kf[p])
            if ref not in old_pose:
                continue
            Ro, to = old_pose[ref]
            Rn, tn = new_pose[ref]
            xc = Ro @ pt.pos[p] + to
            pt.pos[p] = Rn.T @ (xc - tn)
        m.update_points_normal_depth(point_ids)
