"""System facade: the public entry point (reference include/System.h).

Counterpart of orbslam2commentedbyxcm_tpu/models/system.py for synchronous
monocular, stereo and RGB-D SLAM: extractor -> Tracking -> LocalMapping, run
in the caller's thread, on the torch device the System is given. Frames go in
through `track_monocular` / `track_rgbd` / `track_stereo`, which return the
(4, 4) float32 pose Tcw or None when the frame was not tracked.

    system = System(camera, Sensor.MONOCULAR, enable_loop_closing=False, device="cuda")
    t_cw = system.track_monocular(image, timestamp)

With `vocabulary` ("bootstrap" or an ops/bow Vocabulary) keyframes are
registered in a BoW keyframe database, the reference-keyframe stage tries a
BoW search first, and a lost tracker relocalizes (models/relocalization).
`activate_localization_mode` freezes the map and tracks with the
visual-odometry fallback. `vocabulary=None` means no place recognition: the
JAX package instead trains a small vocabulary from the map once it holds 5
keyframes, which is not ported (ROADMAP.md Queue 3).

Options that belong to later slices raise NotImplementedError naming their
ROADMAP.md Queue 1 item: loop closing, the async pipeline, the tracer, the
multi-device mesh and map save/load.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.models.frame import Frame, rgbd_observations
from orbslam2commentedbyxcm_tpu_torch.models.keyframe_database import KeyFrameDatabase
from orbslam2commentedbyxcm_tpu_torch.models.local_mapping import LocalMapping
from orbslam2commentedbyxcm_tpu_torch.models.map import Map
from orbslam2commentedbyxcm_tpu_torch.models.relocalization import Relocalizer
from orbslam2commentedbyxcm_tpu_torch.models.tracking import Tracking, TrackingConfig, TrackingState
from orbslam2commentedbyxcm_tpu_torch.ops import bow
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
from orbslam2commentedbyxcm_tpu_torch.ops.stereo import stereo_match_frame
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import rot_to_quat


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported to the PyTorch package yet (ROADMAP.md Queue 1 item {item})")


class _DbOnlyRegistrar:
    """Registers each keyframe's BoW vector and grouping nodes in the
    keyframe database, without loop detection (place recognition with loop
    closing disabled: relocalization still needs the database)."""

    def __init__(self, system):
        self.system = system

    def insert_keyframe(self, kf_id: int):
        sys_ = self.system
        kf = sys_.map.keyframes.get(kf_id)
        if kf is None or sys_.vocabulary is None:
            return
        words, groups, weights = bow.transform(sys_.vocabulary, kf.desc, kf.valid, device=sys_.device)
        ids, vals = bow.bow_vector(words, weights, sys_.vocabulary.n_words)
        kf.bow_vec = (ids, vals)
        kf.bow_feat_nodes = groups
        sys_.keyframe_db.add(kf_id, ids, vals)


class System:
    def __init__(
        self,
        camera: Camera,
        sensor: Sensor = Sensor.MONOCULAR,
        config: TrackingConfig | None = None,
        vocabulary=None,
        enable_loop_closing: bool = True,
        async_mapping: bool = False,
        tracer=None,
        mesh=None,
        init_feature_boost: float = 2.0,  # monocular initialization only
        device="cuda",
    ):
        if enable_loop_closing:
            _not_ported("loop closing (pass enable_loop_closing=False)", 9)
        if async_mapping:
            _not_ported("the async mapping pipeline", 10)
        if tracer is not None:
            _not_ported("the tracer", 10)
        if mesh is not None:
            _not_ported("the multi-device mesh", 11)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("System(device='cuda'): no CUDA device is available")
        self.camera = camera
        self.sensor = sensor
        self.cfg = config or TrackingConfig()
        self.map = Map(device=self.device)
        # pre-reset trajectory segments, materialized as absolute poses
        self._archived_trajectory: list = []
        self._archived_kf_trajectory: list = []
        self.extractor = ORBExtractor(
            n_features=self.cfg.n_features,
            scale_factor=self.cfg.scale_factor,
            n_levels=self.cfg.n_levels,
            normalize_exposure=self.cfg.normalize_exposure,
            exposure_target_mad=self.cfg.exposure_target_mad,
        )
        # monocular initialization extracts with a doubled budget (reference
        # mpIniORBextractor, src/Tracking.cc:121-126); the two init frames are
        # compacted back to the standard capacity (Frame.compact_to)
        self._init_extractor = None
        if sensor == Sensor.MONOCULAR and init_feature_boost > 1.0:
            self._init_extractor = ORBExtractor(
                n_features=int(self.cfg.n_features * init_feature_boost),
                scale_factor=self.cfg.scale_factor,
                n_levels=self.cfg.n_levels,
                normalize_exposure=self.cfg.normalize_exposure,
                exposure_target_mad=self.cfg.exposure_target_mad,
            )
        self.local_mapping = LocalMapping(self.map, camera)
        self.tracking = Tracking(camera, self.map, self.local_mapping, self.cfg,
                                 std_capacity=self.extractor.capacity)
        if vocabulary == "bootstrap":
            vocabulary = bow.bootstrap_vocabulary()
        self.vocabulary = vocabulary
        self.keyframe_db = None
        if vocabulary is not None:
            self._wire_place_recognition()

    def _wire_place_recognition(self):
        """Keyframe database (erased keyframes leave it through the map's
        erase hook), the registrar as the mapper's loop_closer hand-off, the
        relocalizer, and the tracker's vocabulary. The tree is uploaded to
        the System's device here, once."""
        self.vocabulary.device_tree(self.device)
        self.keyframe_db = KeyFrameDatabase(self.vocabulary)
        self.map.erase_hooks.append(self.keyframe_db.erase)
        self.local_mapping.loop_closer = _DbOnlyRegistrar(self)
        self.local_mapping.relocalizer = Relocalizer(self.map, self.camera, keyframe_db=self.keyframe_db,
                                                     vocabulary=self.vocabulary)
        self.tracking.vocabulary = self.vocabulary

    # -- frame entry points ------------------------------------------------

    def _image(self, image) -> torch.Tensor:
        """(H, W) or (H, W, C) numpy array or tensor -> (H, W) float32 on the
        System's device (grayscale as the mean of the channels, :301-312)."""
        if isinstance(image, torch.Tensor):
            img = image.to(self.device, torch.float32)
            return img.mean(dim=-1) if img.dim() == 3 else img
        img = np.asarray(image)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        return torch.from_numpy(img.astype(np.float32)).to(self.device)

    def _make_frame(self, img: torch.Tensor, timestamp: float) -> Frame:
        ext = self.extractor
        if self._init_extractor is not None and self.tracking.state == TrackingState.NOT_INITIALIZED:
            ext = self._init_extractor  # the doubled budget while initializing
        frame = Frame(ext(img), self.camera, timestamp, self.cfg.scale_factor, self.cfg.n_levels)
        if self.camera.has_distortion:
            frame.uv_und = self.camera.undistort_points(frame.feats.uv).cpu().numpy()
        return frame

    def _track_locked(self, frame: Frame):
        state = self.tracking.track_frame(frame)
        # lost right after initialization: the young map is too small to
        # recover from, so reset (reference src/Tracking.cc:518-525)
        if (state == TrackingState.LOST and not self.tracking.localization_only
                and 0 < len(self.map.good_keyframes()) <= 5):
            self.reset()
        return state

    def track_monocular(self, image, timestamp: float):
        """-> Tcw (4, 4) float32, or None if the frame was not tracked."""
        if self.sensor != Sensor.MONOCULAR:
            raise ValueError(f"track_monocular on a {self.sensor.name} system")
        frame = self._make_frame(self._image(image), timestamp)
        state = self._track_locked(frame)
        return frame.t_cw.copy() if state == TrackingState.OK else None

    def track_rgbd(self, image, depth, timestamp: float):
        """-> Tcw (4, 4) float32, or None if the frame was not tracked."""
        if self.sensor != Sensor.RGBD:
            raise ValueError(f"track_rgbd on a {self.sensor.name} system")
        frame = self._make_frame(self._image(image), timestamp)
        self._attach_depth(frame, depth)
        state = self._track_locked(frame)
        return frame.t_cw.copy() if state == TrackingState.OK else None

    def track_stereo(self, image_left, image_right, timestamp: float):
        """Rectified stereo pair -> Tcw (4, 4) float32, or None."""
        if self.sensor != Sensor.STEREO:
            raise ValueError(f"track_stereo on a {self.sensor.name} system")
        left = self._image(image_left)
        frame = self._make_frame(left, timestamp)
        stereo_match_frame(frame, left, self._image(image_right), self.extractor, self.camera)
        state = self._track_locked(frame)
        return frame.t_cw.copy() if state == TrackingState.OK else None

    def _attach_depth(self, frame: Frame, depth_map):
        """RGB-D pseudo-stereo (reference ComputeStereoFromRGBD,
        src/Frame.cc:888-909): depth sampled at the keypoints, u_right
        synthesized (models/frame.rgbd_observations)."""
        if not isinstance(depth_map, torch.Tensor):
            depth_map = torch.from_numpy(np.asarray(depth_map, np.float32))
        depth_map = depth_map.to(self.device, torch.float32)
        obs, _, depth = rgbd_observations(frame.feats, depth_map, self.camera,
                                          self.cfg.n_levels, self.cfg.scale_factor)
        frame.depth = depth.cpu().numpy()
        frame.u_right = obs[:, 2].cpu().numpy()

    # -- control -----------------------------------------------------------

    def reset(self):
        # materialize the tracked-so-far trajectories into absolute poses
        # before the map (and its reference keyframes) is dropped
        self._archived_trajectory = self.frame_trajectory()
        self._archived_kf_trajectory = self.keyframe_trajectory()
        self.map = Map(device=self.device)
        self.local_mapping.map = self.map
        self.local_mapping.recent_points = []
        t = self.tracking
        t.map = self.map
        t.state = TrackingState.NOT_INITIALIZED
        t.last_frame = None
        t.velocity = None
        t.trajectory = []
        t.init_ref_frame = None
        t.vo_mode = False
        t._prev_local_pids = None  # stale pids index the old map
        t._pack_cache.clear()  # the new map's pt_version restarts from 0
        if self.keyframe_db is not None:
            self.keyframe_db.clear()
            self.map.erase_hooks.append(self.keyframe_db.erase)
            self.local_mapping.relocalizer.map = self.map

    def shutdown(self):
        """A no-op: the synchronous pipeline has no worker to join."""

    def activate_localization_mode(self):
        """Track against the frozen map: no keyframes, no mapping (reference
        System::ActivateLocalizationMode, src/System.cc:147-172)."""
        self.tracking.localization_only = True
        self.local_mapping.paused = True

    def deactivate_localization_mode(self):
        self.tracking.localization_only = False
        self.tracking.vo_mode = False
        self.local_mapping.paused = False

    def change_calibration(self, camera: Camera):
        """Swap the camera intrinsics in every consumer and drop the motion
        model, so the next frame re-anchors through the reference keyframe
        (reference Tracking::ChangeCalibration, src/Tracking.cc:1735-1764)."""
        self.camera = camera
        self.tracking.camera = camera
        self.local_mapping.camera = camera
        if self.local_mapping.relocalizer is not None:
            self.local_mapping.relocalizer.camera = camera
        self.tracking.velocity = None

    def save_map(self, path: str):
        _not_ported("map save/load", 9)

    def load_map(self, path: str):
        _not_ported("map save/load", 9)

    # -- introspection ------------------------------------------------------

    def get_tracking_state(self) -> TrackingState:
        return self.tracking.state

    def n_tracked_points(self) -> int:
        return self.tracking.n_last_inliers

    def get_tracked_map_points(self):
        """Map-point ids tracked in the last frame (System::GetTrackedMapPoints)."""
        lf = self.tracking.last_frame
        return np.zeros(0, np.int64) if lf is None else lf.map_pt[lf.map_pt >= 0].copy()

    def get_tracked_keypoints_und(self):
        """Undistorted keypoints of the last frame (System::GetTrackedKeyPointsUn)."""
        lf = self.tracking.last_frame
        return np.zeros((0, 2), np.float32) if lf is None else lf.uv_und[lf.valid].copy()

    def map_changed(self) -> int:
        return self.map.big_change_idx

    # -- trajectory output (reference src/System.cc:347-503) ---------------

    def keyframe_trajectory(self):
        """[(timestamp, Tcw)] for good keyframes, id-ordered, after the poses
        archived at earlier resets."""
        kfs = sorted(self.map.good_keyframes(), key=lambda k: k.kf_id)
        return list(self._archived_kf_trajectory) + [(kf.timestamp, kf.t_cw.copy()) for kf in kfs]

    def frame_trajectory(self):
        """[(timestamp, Tcw)] through the (BA-corrected) reference keyframe
        poses; erased keyframes are traversed via their stored pose relative
        to their spanning-tree parent (reference SaveTrajectoryTUM)."""
        out = list(self._archived_trajectory)
        for ts, ref_id, t_rel in self.tracking.trajectory:
            kf = self.map.keyframes.get(ref_id)
            t_acc = np.eye(4, dtype=np.float32)
            hops = 0
            while kf is not None and kf.bad and kf.parent is not None and hops < 64:
                if kf.t_child_parent is not None:
                    t_acc = t_acc @ kf.t_child_parent
                kf = self.map.keyframes.get(kf.parent)
                hops += 1
            if kf is not None:
                out.append((ts, (t_rel @ t_acc @ kf.t_cw).astype(np.float32)))
        return out

    @staticmethod
    def _write_tum(path: str, trajectory):
        """TUM format: timestamp tx ty tz qx qy qz qw (camera-to-world)."""
        with open(path, "w") as f:
            for ts, t_cw in trajectory:
                t_wc = np.linalg.inv(t_cw)
                q = rot_to_quat(torch.from_numpy(t_wc[:3, :3].astype(np.float32))).numpy()
                t = t_wc[:3, 3]
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_tum(self, path: str):
        self._write_tum(path, self.frame_trajectory())

    def save_keyframe_trajectory_tum(self, path: str):
        self._write_tum(path, self.keyframe_trajectory())

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 12 numbers per row (3x4 camera-to-world)."""
        with open(path, "w") as f:
            for _, t_cw in self.frame_trajectory():
                row = np.linalg.inv(t_cw)[:3].reshape(-1)
                f.write(" ".join(f"{x:.9e}" for x in row) + "\n")
