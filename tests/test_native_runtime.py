"""Native host-runtime extension vs the pure-numpy fallbacks.

The C++ module owns the integer/bit host work of the map bookkeeping
(MapPoint::ComputeDistinctiveDescriptors, MapPoint.cc:245-310;
KeyFrame::UpdateConnections counting, KeyFrame.cc:305).  These tests pin
the batched entry point against both the per-point native function and an
independent numpy reference, and the SlamMap wrapper against the fallback.
"""
import numpy as np


def _numpy_distinctive(D_u8):
    """Independent min-median-Hamming reference."""
    x = D_u8[:, None, :] ^ D_u8[None, :, :]
    dist = np.unpackbits(x, axis=-1).sum(-1)
    med = np.sort(dist, axis=1)[:, (len(D_u8) - 1) // 2]
    return int(np.argmin(med))


def test_batched_distinctive_matches_per_point(rng, native_ext):
    nat = native_ext
    sizes = [5, 1, 9, 2, 17]
    D = rng.integers(0, 256, (sum(sizes), 32)).astype(np.uint8)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    idx = nat.distinctive_descriptors_batch(np.ascontiguousarray(D), off)
    for k, (lo, hi) in enumerate(zip(off[:-1], off[1:])):
        block = np.ascontiguousarray(D[lo:hi])
        assert idx[k] == lo + nat.distinctive_descriptor(block)
        assert idx[k] == lo + _numpy_distinctive(block)


def test_batched_distinctive_empty_block(native_ext):
    nat = native_ext
    D = np.zeros((3, 32), np.uint8)
    off = np.asarray([0, 3, 3], np.int64)   # second point has no obs
    idx = nat.distinctive_descriptors_batch(np.ascontiguousarray(D), off)
    assert idx[1] == -1 and idx[0] >= 0


def test_map_batched_wrapper_matches_fallback(rng, native_ext, monkeypatch):
    """SlamMap.update_point_descriptors == per-point update_point_descriptor
    on the same map state."""
    from airdos_tpu.slam import map as map_mod
    from airdos_tpu.slam.map import SlamMap, KeyFrame
    monkeypatch.setattr(map_mod, "_native", native_ext)

    class _Frame:
        def __init__(self, idx, n):
            self.index = idx
            self.timestamp = 0.0
            self.xy = np.zeros((n, 2), np.float32)
            self.xy_un = np.zeros((n, 2), np.float32)
            self.octave = np.zeros(n, np.int32)
            self.angle = np.zeros(n, np.float32)
            self.response = np.ones(n, np.float32)
            self.desc32 = rng.integers(0, 1 << 32, (n, 8),
                                       dtype=np.int64).astype(np.uint32)
            self.u_right = np.full(n, -1.0, np.float32)
            self.depth = np.full(n, 1.0, np.float32)
            self.valid = np.ones(n, bool)
            self.mp_idx = np.full(n, -1, np.int64)
            self.Rcw = np.eye(3, dtype=np.float32)
            self.tcw = np.zeros(3, np.float32)

    n_feat, n_pts = 24, 12
    m = SlamMap()
    kfs = [KeyFrame(i, _Frame(i, n_feat)) for i in range(4)]
    for kf in kfs:
        m.add_keyframe(kf)
    pids = m.create_points(kfs[0], np.arange(n_pts),
                           rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32))
    for kf in kfs[1:]:
        for j, pid in enumerate(pids):
            m.add_observation(int(pid), kf, j + 3)

    m.update_point_descriptors([int(p) for p in pids])
    got = m.points.desc32[pids].copy()

    # recompute via the per-point path (force the numpy fallback too)
    saved = map_mod._native
    try:
        map_mod._native = None
        for p in pids:
            m.update_point_descriptor(int(p))
    finally:
        map_mod._native = saved
    np.testing.assert_array_equal(got, m.points.desc32[pids])
