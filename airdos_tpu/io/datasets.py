"""Dataset drivers.

TartanAir-Shibuya sequence layout (reference: Examples/Stereo/stereo_human.cc
LoadImages/LoadSegs/LoadDepths, System.cc:496-528):

    <seq>/times.txt               one timestamp per line
    <seq>/image_0/%06d.png        left grayscale/RGB
    <seq>/image_1/%06d.png        right
    <seq>/rcnnseg_image_0/%06d.png  left segmentation (dynamic = nonzero)
    <seq>/rcnnseg_image_1/%06d.png
    <seq>/alphapose_0/%06d.txt    per-frame humans, 54 columns = 18 joints x (x, y, score)
    <seq>/alphapose_1/%06d.txt
    <seq>/track_id_alpha/%06d.txt 1 column: per-human persistent track id (-1 = untracked)

Also provides KITTI odometry stereo layout and a synthetic-sequence
generator used for tests and benchmarking in dataset-free environments.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np


def _cv2():
    """OpenCV, needed only to read and rectify real dataset images."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading dataset images needs OpenCV: install the 'datasets' "
            "extra (pip install 'airdos-tpu[datasets]')") from e
    return cv2


def read_number_txt(path: str | Path, cols: Optional[int] = None) -> np.ndarray:
    """Whitespace matrix loader (reference: System_utils.h read_number_txt).
    Returns [0, cols] when the file is missing (same recovery as reference)."""
    p = Path(path)
    if not p.exists():
        return np.zeros((0, cols or 0))
    try:
        data = np.loadtxt(p, ndmin=2)
    except ValueError:
        return np.zeros((0, cols or 0))
    if data.size == 0:
        return np.zeros((0, cols or 0))
    if cols is not None and data.shape[1] != cols:
        data = data.reshape(-1, cols)
    return data


def read_alphapose_file(path: str | Path) -> np.ndarray:
    """Read one AlphaPose file -> [n_humans, 18, 3] (x, y, score)."""
    data = read_number_txt(path, 54)
    return data.reshape(-1, 18, 3)


def read_track_ids(path: str | Path) -> np.ndarray:
    """Read one track-id file -> [n_humans] int."""
    data = read_number_txt(path, 1)
    return data.reshape(-1).astype(np.int64)


def read_ground_truth_poses(path: str | Path) -> np.ndarray:
    """Read 8-column GT file ``time tx ty tz qw qx qy qz`` (NED-style, as
    consumed by System::ReadGroundTruthPoses) -> raw [N, 8]."""
    return read_number_txt(path, 8)


@dataclasses.dataclass
class FrameData:
    """Everything one tracked frame consumes."""
    timestamp: float
    index: int
    image_left: np.ndarray                 # [H, W] float32 grayscale 0..255
    image_right: np.ndarray
    seg_left: Optional[np.ndarray] = None  # [H, W] uint8 (0 = static)
    seg_right: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    humans_left: Optional[np.ndarray] = None   # [nL, 18, 3]
    humans_right: Optional[np.ndarray] = None  # [nR, 18, 3]
    track_ids: Optional[np.ndarray] = None     # [nL]


class TartanAirStereoSequence:
    """Iterates FrameData over a TartanAir-Shibuya style directory."""

    def __init__(self, root: str | Path, with_masks: bool = True,
                 with_humans: bool = True, start: int = 0, end: int = 0,
                 use_tracked_id: bool = True):
        # use_tracked_id mirrors Human.UseTrackedId: when falsy the
        # track_id_alpha/ files are not read, so every human observation
        # carries track id -1 and never enters a trajectory — the
        # reference's no-trackid branch (Frame.cc:273-275 human_idx = -1)
        self.use_tracked_id = bool(use_tracked_id)
        self.root = Path(root)
        ts = []
        times_file = self.root / "times.txt"
        if times_file.exists():
            for line in times_file.read_text().splitlines():
                line = line.strip()
                if line:
                    ts.append(float(line.split()[0]))
        else:
            n = len(sorted((self.root / "image_0").glob("*.png")))
            ts = [i * 0.5 for i in range(n)]
        self.timestamps = ts
        self.with_masks = with_masks
        self.with_humans = with_humans
        self.start = start
        self.end = end if end > 0 else len(ts)
        self.end = min(self.end, len(ts))

    def __len__(self):
        return self.end - self.start

    def _imread_gray(self, path: Path) -> Optional[np.ndarray]:
        if not path.exists():
            return None
        cv2 = _cv2()
        im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if im is None:
            return None
        if im.ndim == 3:
            im = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
        return im.astype(np.float32)

    def __iter__(self):
        for i in range(self.start, self.end):
            yield self[i]

    def __getitem__(self, i: int) -> FrameData:
        name = f"{i:06d}"
        imL = self._imread_gray(self.root / "image_0" / f"{name}.png")
        imR = self._imread_gray(self.root / "image_1" / f"{name}.png")
        segL = segR = None
        if self.with_masks:
            segL = self._imread_gray(self.root / "rcnnseg_image_0" / f"{name}.png")
            segR = self._imread_gray(self.root / "rcnnseg_image_1" / f"{name}.png")
            segL = segL.astype(np.uint8) if segL is not None else None
            segR = segR.astype(np.uint8) if segR is not None else None
        humL = humR = tids = None
        if self.with_humans:
            humL = read_alphapose_file(self.root / "alphapose_0" / f"{name}.txt")
            humR = read_alphapose_file(self.root / "alphapose_1" / f"{name}.txt")
            tids = read_track_ids(self.root / "track_id_alpha" / f"{name}.txt") \
                if self.use_tracked_id else None
        return FrameData(timestamp=self.timestamps[i], index=i,
                         image_left=imL, image_right=imR,
                         seg_left=segL, seg_right=segR,
                         humans_left=humL, humans_right=humR, track_ids=tids)


class KittiStereoSequence(TartanAirStereoSequence):
    """KITTI odometry layout: same image_0/image_1 + times.txt, no
    masks/humans (reference: stereo_kitti.cc)."""

    def __init__(self, root: str | Path, start: int = 0, end: int = 0):
        super().__init__(root, with_masks=False, with_humans=False,
                         start=start, end=end)


def read_opencv_yaml_matrices(path: str | Path) -> dict:
    """Parse a cv::FileStorage YAML's !!opencv-matrix nodes (and scalar
    keys) — enough for the reference EuRoC.yaml rectification blocks
    (LEFT.K / LEFT.D / LEFT.R / LEFT.P and RIGHT.*)."""
    import re
    text = Path(path).read_text()
    out: dict = {}
    # scalars
    for m in re.finditer(r"^([A-Za-z0-9_.]+):\s*([-0-9.eE+]+)\s*$", text,
                         re.MULTILINE):
        try:
            v = float(m.group(2))
            out[m.group(1)] = int(v) if v == int(v) else v
        except ValueError:
            pass
    # matrices: KEY: !!opencv-matrix \n rows.. cols.. dt.. data: [ ... ]
    pat = re.compile(
        r"^([A-Za-z0-9_.]+):\s*!!opencv-matrix\s*\n"
        r"\s*rows:\s*(\d+)\s*\n\s*cols:\s*(\d+)\s*\n\s*dt:\s*\w+\s*\n"
        r"\s*data:\s*\[([^\]]*)\]", re.MULTILINE)
    for m in pat.finditer(text):
        rows, cols = int(m.group(2)), int(m.group(3))
        data = np.asarray([float(x) for x in m.group(4).replace("\n", " ")
                           .split(",") if x.strip()])
        out[m.group(1)] = data.reshape(rows, cols)
    return out


class EurocStereoSequence:
    """EuRoC MAV layout (reference: stereo_euroc.cc): mav0/cam0/data +
    timestamp filenames in ns; raw images are undistorted + rectified with
    the LEFT.*/RIGHT.* calibration blocks (stereo_euroc.cc:71-107) when a
    settings YAML is given."""

    def __init__(self, root: str | Path, timestamps_file: str | Path,
                 settings_yaml: Optional[str | Path] = None,
                 start: int = 0, end: int = 0):
        self.root = Path(root)
        ts_ns = [int(l.strip()) for l in Path(timestamps_file).read_text().splitlines()
                 if l.strip()]
        self.names = [str(t) for t in ts_ns]
        self.timestamps = [t / 1e9 for t in ts_ns]
        self.start = start
        self.end = end if end > 0 else len(self.timestamps)
        self._maps = None
        if settings_yaml is not None:
            self._build_rectify_maps(settings_yaml)

    def _build_rectify_maps(self, settings_yaml):
        cv2 = _cv2()
        c = read_opencv_yaml_matrices(settings_yaml)
        need = ["LEFT.K", "LEFT.D", "LEFT.R", "LEFT.P",
                "RIGHT.K", "RIGHT.D", "RIGHT.R", "RIGHT.P"]
        if not all(k in c for k in need):
            raise ValueError(
                f"{settings_yaml} lacks rectification blocks {need} "
                f"(reference stereo_euroc.cc:81-86 aborts the same way)")
        rows = int(c.get("LEFT.height", 480))
        cols = int(c.get("LEFT.width", 752))
        self._maps = []
        for side in ("LEFT", "RIGHT"):
            m1, m2 = cv2.initUndistortRectifyMap(
                c[f"{side}.K"], c[f"{side}.D"], c[f"{side}.R"],
                c[f"{side}.P"][:3, :3], (cols, rows), cv2.CV_32F)
            self._maps.append((m1, m2))

    def __len__(self):
        return self.end - self.start

    def _rectify(self, im, side: int):
        if im is None or self._maps is None:
            return im
        cv2 = _cv2()
        m1, m2 = self._maps[side]
        return cv2.remap(im, m1, m2, cv2.INTER_LINEAR)

    def __getitem__(self, i: int) -> FrameData:
        cv2 = _cv2()
        imL = cv2.imread(str(self.root / "mav0/cam0/data" / (self.names[i] + ".png")),
                         cv2.IMREAD_GRAYSCALE)
        imR = cv2.imread(str(self.root / "mav0/cam1/data" / (self.names[i] + ".png")),
                         cv2.IMREAD_GRAYSCALE)
        imL = self._rectify(imL, 0)
        imR = self._rectify(imR, 1)
        return FrameData(timestamp=self.timestamps[i], index=i,
                         image_left=None if imL is None else imL.astype(np.float32),
                         image_right=None if imR is None else imR.astype(np.float32))

    def __iter__(self):
        for i in range(self.start, self.end):
            yield self[i]
