"""Front-end kernel tests vs OpenCV oracles (FAST, IC angle, rBRIEF)."""
import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from airdos_tpu.ops.fast import fast_score_map
from airdos_tpu.ops.filters import gaussian_blur7, erode
from airdos_tpu.ops.brief import compute_descriptors, load_pattern, pack_u32
from airdos_tpu.ops.orientation import ic_angle_maps, _umax, HALF_PATCH
from airdos_tpu.ops.hamming import hamming_matrix, hamming_distance
from airdos_tpu.features.orb import OrbExtractor, level_quotas


def textured_image(rng, h=240, w=320):
    img = (rng.uniform(0, 255, (h, w))).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.0)
    img = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX)
    return img.astype(np.uint8)


def test_fast_detection_matches_cv2(rng):
    img = textured_image(rng)
    th = 20
    det = cv2.FastFeatureDetector_create(th, nonmaxSuppression=True)
    kps = det.detect(img)
    cv_set = {(int(round(k.pt[0])), int(round(k.pt[1]))) for k in kps
              if 8 < k.pt[0] < img.shape[1] - 8 and 8 < k.pt[1] < img.shape[0] - 8}

    from airdos_tpu.ops.fast import fast_corners
    corner = np.asarray(fast_corners(jnp.asarray(img, jnp.float32), th))
    ours = np.argwhere(corner > 0)
    our_set = {(int(x), int(y)) for y, x in ours
               if 8 < x < img.shape[1] - 8 and 8 < y < img.shape[0] - 8}

    inter = len(cv_set & our_set)
    assert len(cv_set) > 50
    assert inter / max(1, len(cv_set)) > 0.85
    assert inter / max(1, len(our_set)) > 0.85


def test_fast_score_matches_cv2_response(rng):
    img = textured_image(rng)
    th = 20
    det = cv2.FastFeatureDetector_create(th, nonmaxSuppression=True)
    kps = det.detect(img)
    score = np.asarray(fast_score_map(jnp.asarray(img, jnp.float32)))
    errs = []
    for k in kps[:200]:
        x, y = int(round(k.pt[0])), int(round(k.pt[1]))
        errs.append(abs((score[y, x] - 1) - k.response))
    assert np.median(errs) <= 1.0


def numpy_ic_angle(img, x, y):
    """Reference IC_Angle oracle (ORBextractor.cc:78-105 semantics)."""
    umax = _umax()
    m01 = m10 = 0.0
    for dy in range(-HALF_PATCH, HALF_PATCH + 1):
        u = umax[abs(dy)]
        for dx in range(-u, u + 1):
            v = float(img[y + dy, x + dx])
            m10 += dx * v
            m01 += dy * v
    ang = np.degrees(np.arctan2(m01, m10))
    return ang + 360 if ang < 0 else ang


def test_ic_angle_conv_matches_loop(rng):
    img = textured_image(rng, 96, 128).astype(np.float32)
    m10, m01 = ic_angle_maps(jnp.asarray(img))
    m10, m01 = np.asarray(m10), np.asarray(m01)
    for (x, y) in [(40, 40), (60, 30), (100, 70), (20, 50)]:
        ang_ref = numpy_ic_angle(img, x, y)
        ang_ours = np.degrees(np.arctan2(m01[y, x], m10[y, x])) % 360
        assert abs((ang_ours - ang_ref + 180) % 360 - 180) < 0.1


def test_brief_descriptors_match_cv2(rng):
    img = textured_image(rng)
    # keypoints well inside the border, fixed angles
    pts = [(50, 60), (100, 100), (200, 150), (260, 80), (150, 40)]
    angles = [0.0, 37.5, 200.0, 91.0, 315.0]
    kps = [cv2.KeyPoint(float(x), float(y), 31.0, a, 1.0, 0)
           for (x, y), a in zip(pts, angles)]
    orb = cv2.ORB_create(nlevels=1, edgeThreshold=19)
    _, desc_cv = orb.compute(img, kps)

    blurred = gaussian_blur7(jnp.asarray(img, jnp.float32))
    xs = jnp.asarray([p[0] for p in pts], jnp.int32)
    ys = jnp.asarray([p[1] for p in pts], jnp.int32)
    angs = jnp.asarray(angles, jnp.float32)
    desc = np.asarray(compute_descriptors(blurred, xs, ys, angs))

    # bit-level agreement (tiny blur-rounding flips allowed)
    dist = [cv2.norm(desc_cv[i], desc[i], cv2.NORM_HAMMING) for i in range(len(pts))]
    assert np.mean(dist) < 8, dist


def test_hamming_matrix(rng):
    a8 = rng.integers(0, 256, (16, 32)).astype(np.uint8)
    b8 = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    a = np.asarray(pack_u32(jnp.asarray(a8)))
    b = np.asarray(pack_u32(jnp.asarray(b8)))
    D = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    for i in [0, 5, 15]:
        for j in [0, 7, 23]:
            expect = cv2.norm(a8[i], b8[j], cv2.NORM_HAMMING)
            assert D[i, j] == expect
    d = np.asarray(hamming_distance(jnp.asarray(a), jnp.asarray(a)))
    assert (d == 0).all()


def test_level_quotas():
    q = level_quotas(1500, 8, 1.2)
    assert sum(q) == 1500
    assert q[0] > q[1] > q[7] > 0


def test_orb_extractor_end_to_end(rng):
    img = textured_image(rng, 360, 640).astype(np.float32)
    ext = OrbExtractor(n_features=500, n_levels=4)
    feats = ext(jnp.asarray(img))
    assert feats.n_slots == 512        # padded to a multiple of 128
    assert int(feats.valid.sum()) <= 500
    valid = np.asarray(feats.valid)
    assert valid.sum() > 300
    xy = np.asarray(feats.xy)[valid]
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 640).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 360).all()
    # all four levels populated
    octs = np.asarray(feats.octave)[valid]
    assert set(octs.tolist()) == {0, 1, 2, 3}
    # spatial spread: keypoints should cover at least half the image quadrants
    qx = (xy[:, 0] // 320).astype(int)
    qy = (xy[:, 1] // 180).astype(int)
    assert len(set(zip(qx.tolist(), qy.tolist()))) == 4


def test_orb_extractor_mask(rng):
    img = textured_image(rng, 240, 320).astype(np.float32)
    mask = np.ones((240, 320), np.float32)
    mask[:, 160:] = 0.0   # mask out right half (dynamic region)
    ext = OrbExtractor(n_features=300, n_levels=3)
    feats = ext(jnp.asarray(img), jnp.asarray(mask))
    valid = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)[valid]
    # eroded margin: nothing at or right of the boundary
    assert (xy[:, 0] < 160).all()
    assert valid.sum() > 50


@pytest.mark.parametrize("n, m", [(1, 1), (7, 300), (129, 5), (256, 256),
                                  (1000, 77)])
def test_hamming_matrix_matches_numpy_popcount(n, m):
    from airdos_tpu.ops import reference
    rng = np.random.default_rng(n * 1000 + m)
    a = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    D = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    assert D.shape == (n, m) and D.dtype == np.int32
    np.testing.assert_array_equal(D, reference.hamming_matrix(a, b))


def _border_keypoints(rng, h, w, n):
    """Random keypoints plus the four extractor-border corners, where the
    rotated BRIEF samples (radius > 16) clip at the image edge."""
    xs = np.concatenate([rng.integers(16, w - 16, n - 4),
                         [16, w - 17, 16, w - 17]]).astype(np.int32)
    ys = np.concatenate([rng.integers(16, h - 16, n - 4),
                         [16, 16, h - 17, h - 17]]).astype(np.int32)
    return xs, ys


def test_gather_ops_match_numpy_reference(rng):
    """The device front-end ops against the plain numpy references:
    descriptors bit-exact given the same angles (rounding ties excluded),
    angles within float32 noise, SAD windows exact."""
    from airdos_tpu.matching.stereo import SAD_L, SAD_W, sad_windows
    from airdos_tpu.ops import reference
    from airdos_tpu.ops.orientation import keypoint_angles

    h, w, n = 120, 160, 64
    img = textured_image(rng, h, w).astype(np.float32)
    xs, ys = _border_keypoints(rng, h, w, n)
    ang = np.asarray(keypoint_angles(jnp.asarray(img), jnp.asarray(xs),
                                     jnp.asarray(ys)))
    want = reference.ic_angles(img, xs, ys)
    assert np.abs((ang - want + 180.0) % 360.0 - 180.0).max() < 1e-3

    blurred = np.asarray(gaussian_blur7(jnp.asarray(img)))
    angs = rng.uniform(0, 360, n).astype(np.float32)
    desc = np.asarray(compute_descriptors(jnp.asarray(blurred),
                                          jnp.asarray(xs), jnp.asarray(ys),
                                          jnp.asarray(angs)))
    ref_desc, tie = reference.brief_descriptors(blurred, xs, ys, angs)
    assert tie.sum() < 4
    np.testing.assert_array_equal(desc[~tie], ref_desc[~tie])

    L = 3
    pyr_l = rng.uniform(0, 255, (L, h, w)).astype(np.float32)
    pyr_r = rng.uniform(0, 255, (L, h, w)).astype(np.float32)
    oct_l = rng.integers(0, L, n).astype(np.int32)
    dyw = np.arange(-SAD_W, SAD_W + 1)
    dxr = np.arange(-SAD_W - SAD_L, SAD_W + SAD_L + 1)
    gy = np.clip(ys[:, None] + dyw[None], 0, h - 1)
    gxl = np.clip(xs[:, None] + dyw[None], 0, w - 1)
    gxr = np.clip(xs[:, None] + dxr[None], 0, w - 1)
    got = sad_windows(*(jnp.asarray(v) for v in
                        (pyr_l, pyr_r, oct_l, gy, gxl, gxr)))
    for g, r in zip(got, reference.sad_windows(pyr_l, pyr_r, oct_l, gy,
                                               gxl, gxr)):
        np.testing.assert_array_equal(np.asarray(g), r)
