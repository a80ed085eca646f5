"""The numpy rasteriser of the synthetic world against OpenCV, and the
world's renderer with OpenCV unavailable."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from airdos_tpu.io.raster import draw_line, fill_circle

REPO = Path(__file__).resolve().parent.parent


# the world draws dots of radius 1-8 px (and their half-radius satellites)
@pytest.mark.parametrize("radius", range(1, 9))
def test_fill_circle_matches_cv2(radius):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(radius)
    for _ in range(60):
        h, w = 40, 56
        c = (int(rng.integers(-10, w + 10)), int(rng.integers(-10, h + 10)))
        want = np.full((h, w), 90.0)
        got = want.copy()
        cv2.circle(want, c, radius, 7.5, -1)
        fill_circle(got, c, radius, 7.5)
        np.testing.assert_array_equal(got, want, err_msg=f"center {c}")


# limb capsules are drawn 1 px to ~190 px thick, the seg mask >= 3 px
@pytest.mark.parametrize("thickness", [1, 2, 3, 4, 5, 7, 10, 16, 31, 64, 190])
def test_draw_line_matches_cv2(thickness):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(thickness)
    for i in range(60):
        h, w = 72, 96
        p1 = (int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40)))
        p2 = p1 if i == 0 else (int(rng.integers(-40, w + 40)),
                                int(rng.integers(-40, h + 40)))
        want = np.zeros((h, w), np.uint8)
        got = want.copy()
        cv2.line(want, p1, p2, 255, thickness)
        draw_line(got, p1, p2, 255, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} -> {p2}")


def test_raster_rejects_bad_sizes():
    img = np.zeros((4, 4))
    with pytest.raises(ValueError):
        fill_circle(img, (1, 1), -1, 1.0)
    with pytest.raises(ValueError):
        draw_line(img, (0, 0), (3, 3), 1.0, 0)


def test_renderer_runs_without_cv2():
    """Dots, limbs, seg masks and depth render with cv2 unimportable."""
    code = """
import sys
sys.modules["cv2"] = None
import numpy as np
from airdos_tpu.io.synthetic import SyntheticStereoWorld, small_camera
world = SyntheticStereoWorld(seed=3, n_points=120, cam=small_camera(),
                             n_humans=2)
Rwc, twc = world.trajectory(1, 0.1)
f = world.frame(0, Rwc[0], twc[0], 0.0, with_humans=True, with_depth=True)
assert np.isfinite(f.image_left).all() and f.depth.max() > 0
assert f.seg_left is not None and f.seg_left.any()
print("rendered")
"""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "rendered" in res.stdout
