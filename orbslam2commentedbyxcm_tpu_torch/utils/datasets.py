"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

Counterpart of orbslam2commentedbyxcm_tpu/utils/datasets.py: the same
association rules, timestamps and ground-truth parsers, decoding with the
port's own PNG codec (utils/png) instead of cv2. Every reader returns numpy
arrays; the Prefetcher's thread touches no CUDA (the System copies each frame
to its device on the tracking thread).

Covers the reference's example loaders (CMakeLists.txt:84-123 targets
rgbd_tum / stereo_kitti / stereo_euroc / mono_* — sources absent from the
snapshot; formats per README.md:101-173): associations, timestamps, image
paths, ground-truth parsing for evaluation.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from orbslam2commentedbyxcm_tpu_torch.utils import png


def _imread_gray(path: str) -> np.ndarray:
    return png.imread_gray(path).astype(np.float32)


@dataclasses.dataclass
class FrameRecord:
    timestamp: float
    rgb_path: str | None = None
    depth_path: str | None = None
    right_path: str | None = None


class TumRgbdDataset:
    """TUM RGB-D: rgb.txt + depth.txt associated by nearest timestamp
    (the associate.py workflow, reference README.md:155-166)."""

    def __init__(self, root: str, max_dt: float = 0.02, depth_factor: float = 5000.0):
        self.root = root
        self.depth_factor = depth_factor
        rgb = self._read_list(os.path.join(root, "rgb.txt"))
        depth = self._read_list(os.path.join(root, "depth.txt"))
        self.frames: list[FrameRecord] = []
        d_ts = np.array([t for t, _ in depth])
        for t, path in rgb:
            j = int(np.argmin(np.abs(d_ts - t)))
            if abs(d_ts[j] - t) <= max_dt:
                self.frames.append(FrameRecord(t, rgb_path=path, depth_path=depth[j][1]))

    @staticmethod
    def _read_list(path: str):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                out.append((float(ts), os.path.join(os.path.dirname(path), rel)))
        return out

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        fr = self.frames[i]
        img = _imread_gray(fr.rgb_path)
        depth = png.read_png(fr.depth_path).astype(np.float32)
        depth = np.where(depth > 0, depth / self.depth_factor, -1.0)
        return fr.timestamp, img, depth

    def groundtruth(self):
        """(timestamps, positions (N, 3)) from groundtruth.txt if present."""
        path = os.path.join(self.root, "groundtruth.txt")
        if not os.path.exists(path):
            return None
        rows = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                vals = line.split()
                if len(vals) >= 4:
                    rows.append([float(v) for v in vals[:4]])
        arr = np.array(rows)
        return arr[:, 0], arr[:, 1:4]


class KittiOdometryDataset:
    """KITTI odometry: sequences/NN/image_0 (left) + image_1 (right) + times.txt."""

    def __init__(self, root: str, sequence: str = "00"):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        with open(os.path.join(self.seq_dir, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.left_dir = os.path.join(self.seq_dir, "image_0")
        self.right_dir = os.path.join(self.seq_dir, "image_1")
        self.poses_path = os.path.join(root, "poses", sequence + ".txt")

    def __len__(self):
        return len(self.times)

    def __getitem__(self, i):
        name = f"{i:06d}.png"
        left = _imread_gray(os.path.join(self.left_dir, name))
        right_path = os.path.join(self.right_dir, name)
        right = _imread_gray(right_path) if os.path.exists(right_path) else None
        return self.times[i], left, right

    def groundtruth(self):
        if not os.path.exists(self.poses_path):
            return None
        rows = np.loadtxt(self.poses_path).reshape(-1, 3, 4)
        return np.asarray(self.times[: len(rows)]), rows[:, :, 3]


class EurocDataset:
    """EuRoC MAV: mav0/cam0/data + cam1/data with data.csv timestamps (ns).

    EuRoC ships RAW distorted, non-coplanar stereo frames; pass a
    `rectifier` (utils/rectify.StereoRectifier built from the settings'
    LEFT.*/RIGHT.* K/D/R/P) so frames are undistorted + row-aligned before
    the stereo matcher — the reference's stereo_euroc contract
    (the reference's README.md:207). Rectification runs here, i.e. on the
    Prefetcher's IO thread, overlapped with tracking."""

    def __init__(self, root: str, rectifier=None):
        self.rectifier = rectifier
        self.cam0 = os.path.join(root, "mav0", "cam0")
        self.cam1 = os.path.join(root, "mav0", "cam1")
        self.frames: list[FrameRecord] = []
        with open(os.path.join(self.cam0, "data.csv")) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                ts_ns, name = line.strip().split(",")[:2]
                left = os.path.join(self.cam0, "data", name)
                right = os.path.join(self.cam1, "data", name)
                self.frames.append(
                    FrameRecord(float(ts_ns) * 1e-9, rgb_path=left,
                                right_path=right if os.path.exists(right) else None)
                )

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        fr = self.frames[i]
        left = _imread_gray(fr.rgb_path)
        right = _imread_gray(fr.right_path) if fr.right_path else None
        if self.rectifier is not None:
            left = self.rectifier.rectify_left(left)
            if right is not None:
                right = self.rectifier.rectify_right(right)
        return fr.timestamp, left, right

    def groundtruth(self):
        gt = os.path.join(os.path.dirname(self.cam0), "state_groundtruth_estimate0", "data.csv")
        if not os.path.exists(gt):
            return None
        rows = []
        with open(gt) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = line.strip().split(",")
                rows.append([float(v[0]) * 1e-9, float(v[1]), float(v[2]), float(v[3])])
        arr = np.array(rows)
        return arr[:, 0], arr[:, 1:4]


class Prefetcher:
    """Background-thread frame prefetcher over any indexable dataset.

    The reference's example mains read+decode each image synchronously on the
    tracking thread (README.md:101-173 workflow); here disk IO and PNG decode
    overlap tracking compute. Iterate to consume in order:

        for ts, img, aux in Prefetcher(dataset): ...
    """

    def __init__(self, dataset, depth: int = 4, start: int = 0, stop: int | None = None):
        import queue as _queue
        import threading

        self.dataset = dataset
        self._q = _queue.Queue(maxsize=max(1, depth))
        self._stop_evt = threading.Event()
        self._range = range(start, len(dataset) if stop is None else min(stop, len(dataset)))
        self._thread = threading.Thread(target=self._run, daemon=True, name="prefetch")
        self._thread.start()

    def _run(self):
        for i in self._range:
            if self._stop_evt.is_set():
                break
            try:
                item = self.dataset[i]
            except Exception as e:  # surface errors at the consumer
                self._q.put((e, None))
                break
            self._q.put((None, item))
        self._q.put((None, _PREFETCH_END))

    def __len__(self):
        return len(self._range)

    def __iter__(self):
        while True:
            err, item = self._q.get()
            if err is not None:
                raise err
            if item is _PREFETCH_END:
                return
            yield item

    def close(self):
        self._stop_evt.set()
        # drain so the producer can exit
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except Exception:
                self._thread.join(timeout=0.2)


_PREFETCH_END = object()
