"""Frame and KeyFrame containers, and the per-frame observation arrays.

Counterpart of orbslam2commentedbyxcm_tpu/models/frame.py. Host bookkeeping
stays numpy, as in the JAX package: feature arrays, map-point links, the
covisibility weights and the spanning tree. `Frame.device_arrays` holds the
torch tensors that every tracking stage reads, built once per frame on the
device the features were extracted on. Descriptors are uint32 words on the
host (the JAX package's layout) and int32 tensors with the same bits on the
device.

`rgbd_observations` turns extracted features plus an RGB-D depth map into the
pose solver's inputs (the semantics of `System._attach_depth` and
`Frame.stereo_obs`/`inv_sigma2`). `Frame.compact_to` shrinks the two
double-budget frames of a monocular initialization back to the standard
capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.ops.orb import FrameFeatures
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera


def level_sigma2(n_levels: int = 8, scale: float = 1.2) -> np.ndarray:
    """Per-level keypoint variance scale^(2 l) (reference mvLevelSigma2)."""
    return (scale ** (2.0 * np.arange(n_levels))).astype(np.float32)


def rgbd_observations(feats: FrameFeatures, depth_map: torch.Tensor, camera: Camera,
                      n_levels: int = 8, scale_factor: float = 1.2):
    """Features + depth map -> (obs (N, 3), inv_sigma2 (N,), depth (N,)).

    RGB-D pseudo-stereo (reference ComputeStereoFromRGBD, src/Frame.cc:
    888-909): the depth is sampled at the truncated keypoint pixel; where it
    is finite and positive, u_right = u - bf / depth, else u_right = depth =
    -1 (monocular edge). obs is (u, v, u_right) with undistorted (u, v)."""
    uv_und = camera.undistort_points(feats.uv)
    h, w = depth_map.shape
    u = feats.uv[:, 0].long().clamp(0, w - 1)
    v = feats.uv[:, 1].long().clamp(0, h - 1)
    d = depth_map[v, u]
    good = torch.isfinite(d) & (d > 0) & feats.valid
    depth = torch.where(good, d, -1.0)
    # a true division (torch's `scalar / tensor` multiplies by the reciprocal)
    u_right = torch.where(good, uv_und[:, 0] - d.new_tensor(camera.bf) / d, -1.0)
    obs = torch.cat([uv_und, u_right[:, None]], dim=1)
    sigma2 = torch.from_numpy(level_sigma2(n_levels, scale_factor)).to(d.device)
    inv_sigma2 = 1.0 / sigma2[feats.level.long()]
    return obs, inv_sigma2, depth


class Frame:
    """One processed image: fixed-capacity feature arrays + pose + map links.

    `feats` (torch FrameFeatures) stays attached as `self.feats` for the
    device-side stages of this frame (depth attach, stereo search); the
    numpy copies below are the host bookkeeping."""

    _next_id = 0

    def __init__(self, feats: FrameFeatures, camera: Camera, timestamp: float,
                 scale_factor: float = 1.2, n_levels: int = 8):
        self.id = Frame._next_id
        Frame._next_id += 1
        self.timestamp = timestamp
        self.camera = camera
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.feats = feats
        self.device = feats.uv.device

        self.uv = feats.uv.cpu().numpy()
        self.angle = feats.angle.cpu().numpy()
        self.level = feats.level.cpu().numpy()
        self.desc = feats.desc.cpu().numpy().view(np.uint32)
        self.valid = feats.valid.cpu().numpy()
        self.response = feats.response.cpu().numpy()
        self.n = int(self.valid.sum())
        cap = len(self.uv)

        self.uv_und = self.uv.copy()  # filled by the System when the camera has distortion
        self.u_right = np.full(cap, -1.0, np.float32)  # stereo / RGB-D only
        self.depth = np.full(cap, -1.0, np.float32)

        self.t_cw = np.eye(4, dtype=np.float32)
        self.map_pt = np.full(cap, -1, np.int64)  # feature slot -> map point id
        self.is_outlier = np.zeros(cap, bool)
        self._device_cache = None

    @property
    def capacity(self) -> int:
        return len(self.uv)

    def set_pose(self, t_cw: np.ndarray):
        self.t_cw = np.asarray(t_cw, np.float32)

    @property
    def center(self) -> np.ndarray:
        """Camera center in world coords (Ow)."""
        r = self.t_cw[:3, :3]
        return -r.T @ self.t_cw[:3, 3]

    def sigma2(self) -> np.ndarray:
        return level_sigma2(self.n_levels, self.scale_factor)[self.level]

    def inv_sigma2(self) -> np.ndarray:
        return (1.0 / self.sigma2()).astype(np.float32)

    def stereo_obs(self) -> np.ndarray:
        """(N, 3) observations (u, v, u_right) with -1 in col 2 for mono feats."""
        return np.concatenate([self.uv_und, self.u_right[:, None]], axis=1).astype(np.float32)

    def compact_to(self, cap: int, priority_mask: np.ndarray) -> np.ndarray:
        """Shrink the feature arrays to `cap` slots: the valid `priority_mask`
        features first, then the other valid ones by descending FAST
        response. Returns the old -> new slot map (-1 = dropped).

        Used after a monocular initialization with the doubled feature budget
        (reference mpIniORBextractor, src/Tracking.cc:121-126), so keyframe
        arrays keep one shape. The device features (`feats`) are compacted
        with the numpy arrays, and the cached device arrays rebuilt."""
        pri = priority_mask & self.valid
        rest_idx = np.nonzero(self.valid & ~pri)[0]
        order_rest = rest_idx[np.argsort(-self.response[rest_idx])]
        sel = np.concatenate([np.nonzero(pri)[0], order_rest])[:cap]
        old_to_new = np.full(self.capacity, -1, np.int64)
        old_to_new[sel] = np.arange(len(sel))
        fill = {"u_right": -1.0, "depth": -1.0, "map_pt": -1}
        for name in ("uv", "uv_und", "angle", "level", "desc", "valid",
                     "response", "u_right", "depth", "map_pt", "is_outlier"):
            arr = getattr(self, name)
            out = np.full((cap,) + arr.shape[1:], fill.get(name, 0), arr.dtype)
            out[: len(sel)] = arr[sel]
            setattr(self, name, out)
        idx = torch.from_numpy(sel).to(self.device)

        def shrink(t):
            out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
            out[: len(sel)] = t[idx]
            return out

        self.feats = type(self.feats)(*(shrink(t) for t in self.feats))
        self.n = int(self.valid.sum())
        self._device_cache = None
        return old_to_new

    def device_arrays(self) -> dict:
        """The tracking stages' per-frame tensors on the frame's device, built
        once, after uv_und / u_right / depth are final (the System fills
        them before tracking touches the frame)."""
        if self._device_cache is None:
            dev = self.device
            self._device_cache = {
                "uv_und": torch.from_numpy(self.uv_und).to(dev),
                "desc": self.feats.desc,
                "level": self.feats.level,
                "valid": self.feats.valid,
                "angle": self.feats.angle,
                "obs": torch.from_numpy(self.stereo_obs()).to(dev),
                "inv_sigma2": torch.from_numpy(self.inv_sigma2()).to(dev),
            }
        return self._device_cache


class KeyFrame:
    """Persistent frame snapshot (reference include/KeyFrame.h).

    Features are frozen; pose and map-point links mutate under BA. The
    covisibility weights and the spanning tree live here, maintained by
    Map.update_connections."""

    _FEATURES = ("uv", "uv_und", "angle", "level", "desc", "valid", "u_right", "depth")

    def __init__(self, frame: Frame, kf_id: int):
        self.kf_id = kf_id
        self.frame_id = frame.id
        self.timestamp = frame.timestamp
        self.camera = frame.camera
        self.n_levels = frame.n_levels
        self.scale_factor = frame.scale_factor
        for name in self._FEATURES:
            setattr(self, name, getattr(frame, name))
        self.t_cw = frame.t_cw.copy()
        self.map_pt = frame.map_pt.copy()

        self.covis: dict[int, int] = {}     # kf_id -> shared-point weight
        self.parent: int | None = None      # spanning-tree parent kf_id
        self.children: set[int] = set()
        self.loop_edges: set[int] = set()   # loop-closure partners (AddLoopEdge)
        self.bad = False
        self.not_erase = False              # set on loop-edge endpoints: never culled
        self.t_child_parent = None          # mTcp stored on deletion
        self._inv_sigma2 = None
        # BoW vector (word ids, values) and per-feature grouping nodes, set
        # when place recognition registers the keyframe
        self.bow_vec = None
        self.bow_feat_nodes = None

    @property
    def center(self) -> np.ndarray:
        r = self.t_cw[:3, :3]
        return -r.T @ self.t_cw[:3, 3]

    def set_pose(self, t_cw: np.ndarray):
        self.t_cw = np.asarray(t_cw, np.float32)

    def inv_sigma2(self) -> np.ndarray:
        if self._inv_sigma2 is None:  # features are immutable on a KeyFrame
            self._inv_sigma2 = (
                1.0 / level_sigma2(self.n_levels, self.scale_factor)[self.level]
            ).astype(np.float32)
        return self._inv_sigma2

    def best_covisible(self, n: int | None = None) -> list[int]:
        """Covisible keyframe ids ordered by weight (GetBestCovisibilityKeyFrames)."""
        items = sorted(self.covis.items(), key=lambda kv: -kv[1])
        ids = [k for k, _ in items]
        return ids if n is None else ids[:n]

    def stereo_obs(self) -> np.ndarray:
        return np.concatenate([self.uv_und, self.u_right[:, None]], axis=1).astype(np.float32)
