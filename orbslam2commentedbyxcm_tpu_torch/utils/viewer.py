"""Lightweight map/trajectory visualization (matplotlib, headless).

Counterpart of orbslam2commentedbyxcm_tpu/utils/viewer.py over the port's
System, which keeps its map and frames in numpy. matplotlib is imported
inside the drawing functions only: the viewer is off the card's path, and the
card's Python has no matplotlib. One divergence: the threaded viewer reads
the trajectory without draining the mapping pipeline
(`System._frame_trajectory_now`), since it holds the map lock that the
workers and global BA's write-back take (the JAX viewer drains under the
lock).

Replaces the reference's Pangolin Viewer/MapDrawer/FrameDrawer stack
(src/Viewer.cc, src/MapDrawer.cc, src/FrameDrawer.cc) with offline renders:
a top-down map plot (points, keyframe frusta, covisibility edges, trajectory)
and a frame overlay (keypoints + tracked matches + status line). Interactive
GL windows are a non-goal on headless TPU hosts; the `Viewer` class instead
emits periodic PNG frames to a directory (usable as a live view over any
file watcher, or assembled into a video).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np


def _null_ctx():
    return contextlib.nullcontext()


def save_map_plot(system, path: str, gt_positions=None):
    """Top-down (x, z) plot of the map points, keyframes, covisibility and
    loop edges, the frame trajectory and the ground truth."""
    _plot_map(system, path, gt_positions, system.frame_trajectory())


def _plot_map(system, path: str, gt_positions, traj):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = system.map
    fig, ax = plt.subplots(figsize=(8, 8))
    pids = m.all_point_ids()
    if len(pids):
        xyz = m.pt_xyz[pids]
        ax.scatter(xyz[:, 0], xyz[:, 2], s=1, c="k", alpha=0.3, label="map points")

    kfs = sorted(m.good_keyframes(), key=lambda k: k.kf_id)
    centers = np.array([kf.center for kf in kfs]) if kfs else np.zeros((0, 3))
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 2], "b.-", ms=4, lw=1, label="keyframes")
        # covisibility edges
        idx = {kf.kf_id: i for i, kf in enumerate(kfs)}
        for kf in kfs:
            for nb, w in kf.covis.items():
                if nb in idx and nb > kf.kf_id and w >= 30:
                    a, b = centers[idx[kf.kf_id]], centers[idx[nb]]
                    ax.plot([a[0], b[0]], [a[2], b[2]], "g-", lw=0.3, alpha=0.5)
            for le in kf.loop_edges:
                if le in idx:
                    a, b = centers[idx[kf.kf_id]], centers[idx[le]]
                    ax.plot([a[0], b[0]], [a[2], b[2]], "r-", lw=1.5)

    if traj:
        pos = np.array([np.linalg.inv(t)[:3, 3] for _, t in traj])
        ax.plot(pos[:, 0], pos[:, 2], "c-", lw=0.8, alpha=0.8, label="trajectory")
    if gt_positions is not None:
        ax.plot(gt_positions[:, 0], gt_positions[:, 2], "m--", lw=0.8, label="ground truth")

    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(
        f"KFs: {len(kfs)}  points: {m.n_valid_points()}  "
        f"loops: {getattr(system.loop_closing, 'n_loops_closed', 0) if system.loop_closing else 0}"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


class FrameDrawer:
    """Per-frame tracking snapshot + overlay rendering (reference
    src/FrameDrawer.cc: Update copies tracking state, DrawFrame renders
    keypoints/matches, DrawTextInfo prints state/KF/MP/match counts)."""

    def __init__(self, system):
        self.system = system
        # (frame, image) stored as ONE tuple so the threaded viewer's render
        # worker never sees a frame paired with the previous camera image
        self._snapshot = (None, None)

    def update(self, frame, image=None):
        self._snapshot = (frame, image)

    @property
    def frame(self):
        return self._snapshot[0]

    @property
    def image(self):
        return self._snapshot[1]

    def text_info(self) -> str:
        sys_ = self.system
        state = sys_.get_tracking_state().name
        n_kf = len(sys_.map.good_keyframes())
        n_mp = sys_.map.n_valid_points()
        return f"{state} | KFs: {n_kf} | MPs: {n_mp} | matches: {sys_.n_tracked_points()}"

    def draw(self, path: str):
        frame, image = self._snapshot
        if frame is None:
            return
        save_frame_overlay(frame, path, image=image,
                           title_suffix="  " + self.text_info())


class MapDrawer:
    """Map rendering (reference src/MapDrawer.cc: DrawMapPoints,
    DrawKeyFrames, covisibility graph + spanning tree + loop edges,
    DrawCurrentCamera)."""

    def __init__(self, system):
        self.system = system

    def draw(self, path: str, gt_positions=None):
        save_map_plot(self.system, path, gt_positions=gt_positions)


class Viewer:
    """Periodic renderer (reference src/Viewer.cc render loop at ~30 fps —
    here: every `every` tracked frames, write map + frame PNGs to out_dir).

    With `threaded=True` rendering runs on its own worker thread (the
    reference's Viewer thread, spawned src/System.cc:121): `update` only
    enqueues, renders that can't keep up are dropped, and the worker takes
    the system's map lock while reading shared state."""

    def __init__(self, system, out_dir: str, every: int = 30,
                 threaded: bool = False):
        self.system = system
        self.out_dir = out_dir
        self.every = max(1, every)
        self.frame_drawer = FrameDrawer(system)
        self.map_drawer = MapDrawer(system)
        self._count = 0
        os.makedirs(out_dir, exist_ok=True)
        self._queue = None
        self._thread = None
        if threaded:
            import queue
            import threading

            self._queue = queue.Queue(maxsize=2)
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="viewer"
            )
            self._thread.start()

    def update(self, frame, image=None):
        """Call once per tracked frame (the reference wires FrameDrawer::Update
        from Tracking::Track)."""
        self.frame_drawer.update(frame, image)
        self._count += 1
        if self._count % self.every == 0:
            if self._queue is not None:
                try:
                    self._queue.put_nowait(self._count)
                except Exception:
                    pass  # renderer busy: drop this render, never block tracking
            else:
                self._render(self._count)

    def _render(self, count: int):
        lock = getattr(self.system, "map_lock", None)
        ctx = lock if (lock is not None and self._thread is not None) else _null_ctx()
        map_png = os.path.join(self.out_dir, f"map_{count:06d}.png")
        with ctx:
            if self._thread is None:
                self.map_drawer.draw(map_png)
            else:  # under the map lock: read the trajectory without draining
                _plot_map(self.system, map_png, None, self.system._frame_trajectory_now())
            self.frame_drawer.draw(os.path.join(self.out_dir, f"frame_{count:06d}.png"))

    def _run(self):
        while True:
            c = self._queue.get()
            if c is None:
                return
            self._render(c)

    def shutdown(self):
        """Join the render worker (reference Viewer::RequestFinish)."""
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=60)


def save_frame_overlay(frame, path: str, image=None, title_suffix: str = ""):
    """Keypoints + tracked-point overlay (FrameDrawer::DrawFrame analogue)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    if image is not None:
        ax.imshow(image, cmap="gray")
    uv = frame.uv[frame.valid]
    tracked = frame.map_pt[frame.valid] >= 0
    ax.scatter(uv[~tracked, 0], uv[~tracked, 1], s=6, facecolors="none",
               edgecolors="y", lw=0.5, label="keypoints")
    ax.scatter(uv[tracked, 0], uv[tracked, 1], s=8, facecolors="none",
               edgecolors="lime", lw=0.8, label="tracked")
    ax.set_title(
        f"frame {frame.id}: {int(tracked.sum())} tracked / {int(frame.valid.sum())} kps"
        + title_suffix,
        fontsize=9,
    )
    ax.legend(loc="lower right", fontsize=8)
    ax.set_xlim(0, frame.camera.width)
    ax.set_ylim(frame.camera.height, 0)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
