"""System facade: the public entry point (reference include/System.h).

Counterpart of orbslam2commentedbyxcm_tpu/models/system.py for monocular,
stereo and RGB-D SLAM: extractor -> Tracking -> LocalMapping -> LoopClosing
on the torch device the System is given, with global BA on a transient
worker thread. Frames go in through `track_monocular` / `track_rgbd` /
`track_stereo`, which return the (4, 4) float32 pose Tcw or None when the
frame was not tracked.

    system = System(camera, Sensor.RGBD, vocabulary="bootstrap", device="cuda")
    t_cw = system.track_rgbd(image, depth, timestamp)
    system.shutdown()

By default mapping and loop closing run in the caller's thread, inside the
frame that made the keyframe. With `async_mapping=True` they run on two
worker threads (models/async_pipeline, the reference's LocalMapping and
LoopClosing threads): the keyframe frame returns once the keyframe is
queued, and `shutdown()` drains and joins the workers (call it, or
`frame_trajectory()` / `save_map`, before reading the map). `tracer=` (a
utils/tracing Tracer) records the extraction, tracking and mapping spans of
every frame.

With a vocabulary ("bootstrap" or an ops/bow Vocabulary) keyframes are
registered in a BoW keyframe database, the reference-keyframe stage tries a
BoW search first, a lost tracker relocalizes (models/relocalization) and,
with `enable_loop_closing`, loops are detected and closed
(models/loop_closing; the Sim3 is fixed-scale except for monocular). With
`vocabulary=None` a small vocabulary is trained from the map's own
descriptors once it holds 5 keyframes (`_LazyVocabTrainer`), then the same
stack is wired (with loop closing off, the database alone, for
relocalization). `map_lock` (Map::mMutexMapUpdate) is held around tracking,
by the mapping worker, by the loop worker's detection and correction and by
global BA's write-back. `save_map` / `load_map` checkpoint the map in the
JAX package's npz format; a loaded System comes up LOST and relocalizes.
`activate_localization_mode` freezes the map and tracks with the
visual-odometry fallback.

`mesh=` (a parallel/mesh.ShardMesh on the System's device, e.g.
`parallel.mesh.make_mesh(8, device="cuda")`) routes global BA (from 2048
points) and the essential graph (from 256 keyframes) through the sharded
solvers of parallel/ (models/gba, models/loop_closing). The System runs in
one process: a mesh over a torch.distributed group would have every rank
run the whole System in lockstep, which no code here does.

`index="native"` (the default) keeps the Map's observation index and the
keyframe database's inverted file in the host C++ runtime (native/);
`index="python"` runs both on their dict twins. The two make the same
decisions, so they build the same map.
"""

from __future__ import annotations

import enum
import threading

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.models.async_pipeline import AsyncLoopClosing, AsyncMapping
from orbslam2commentedbyxcm_tpu_torch.models.frame import Frame, rgbd_observations
from orbslam2commentedbyxcm_tpu_torch.models.keyframe_database import KeyFrameDatabase
from orbslam2commentedbyxcm_tpu_torch.models.local_mapping import LocalMapping
from orbslam2commentedbyxcm_tpu_torch.models.loop_closing import LoopClosing
from orbslam2commentedbyxcm_tpu_torch.models.map import Map
from orbslam2commentedbyxcm_tpu_torch.models.map_io import load_map as _load_map
from orbslam2commentedbyxcm_tpu_torch.models.map_io import save_map as _save_map
from orbslam2commentedbyxcm_tpu_torch.models.relocalization import Relocalizer
from orbslam2commentedbyxcm_tpu_torch.models.tracking import Tracking, TrackingConfig, TrackingState
from orbslam2commentedbyxcm_tpu_torch.ops import bow
from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
from orbslam2commentedbyxcm_tpu_torch.ops.stereo import stereo_match_frame
from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import same_device
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import rot_to_quat
from orbslam2commentedbyxcm_tpu_torch.utils.tracing import span


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class _LazyVocabTrainer:
    """The mapper's loop_closer hand-off until a vocabulary exists: once the
    map holds 5 good keyframes it trains one from their descriptors and
    passes the keyframe on to the place-recognition stack it wired (the loop
    closer, or with loop closing off the database registrar)."""

    def __init__(self, system):
        self.system = system

    def insert_keyframe(self, kf_id: int):
        sys_ = self.system
        if len(sys_.map.good_keyframes()) >= 5:
            if sys_.train_vocabulary_from_map() and sys_.local_mapping.loop_closer is not self:
                sys_.local_mapping.loop_closer.insert_keyframe(kf_id)


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
        index: str = "native",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("System(device='cuda'): no CUDA device is available")
        if mesh is not None and not same_device(mesh.device, self.device):
            raise ValueError(f"System(mesh=): the mesh is on {mesh.device}, the System on {self.device}")
        self.mesh = mesh
        self.camera = camera
        self.sensor = sensor
        self.cfg = config or TrackingConfig()
        self.tracer = tracer
        self.index = index
        self.map = self._new_map()
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
        # Map::mMutexMapUpdate: held around tracking (which, synchronously,
        # runs mapping and loop closing too), by the async workers and by
        # global BA's write-back
        self.map_lock = threading.Lock()
        self.local_mapping = LocalMapping(self.map, camera)
        self.local_mapping.tracer = tracer
        if async_mapping:
            self.local_mapping = AsyncMapping(self.local_mapping, self.map_lock)
        self._loop_worker: AsyncLoopClosing | None = None
        self.tracking = Tracking(camera, self.map, self.local_mapping, self.cfg,
                                 std_capacity=self.extractor.capacity)
        self.tracking.tracer = tracer
        if vocabulary == "bootstrap":
            vocabulary = bow.bootstrap_vocabulary()
        self.vocabulary = vocabulary
        self.keyframe_db = None
        self.loop_closing = None
        self._enable_loop_closing = enable_loop_closing
        if vocabulary is not None:
            self._wire_place_recognition()
        else:
            # a vocabulary trained from the map's own descriptors once it is
            # big enough (the reference loads ORBvoc.txt, trained offline)
            self.local_mapping.loop_closer = _LazyVocabTrainer(self)

    def _wire_place_recognition(self):
        """Keyframe database (erased keyframes leave it through the map's
        erase hook), the loop closer (or, with loop closing off, the
        registrar) as the mapper's hand-off, the relocalizer, and the
        tracker's vocabulary. The tree is uploaded to the System's device
        here, once. Re-wiring (lazy training, load_map) stops the replaced
        stack's global BA first: a stale solve must not write back later. In
        the async pipeline the loop closer gets its own worker, and the
        replaced one is retired."""
        if self.loop_closing is not None:
            self.loop_closing.gba.abort()
        if self._loop_worker is not None:
            # load_map, from the caller's thread after the drain; the lazy
            # trainer re-wires from the mapping worker, while the map lock is
            # held, but only once and before any loop worker exists (joining
            # one from there could wait for that lock)
            self._loop_worker.shutdown()
            self._loop_worker = None
        self.vocabulary.device_tree(self.device)
        self.keyframe_db = KeyFrameDatabase(self.vocabulary, index=self.index)
        self.map.erase_hooks.append(self.keyframe_db.erase)
        if self._enable_loop_closing:
            self.loop_closing = LoopClosing(self.map, self.camera, keyframe_db=self.keyframe_db,
                                            vocabulary=self.vocabulary, fix_scale=self.sensor != Sensor.MONOCULAR,
                                            map_lock=self.map_lock, device=self.device, mesh=self.mesh)
            if isinstance(self.local_mapping, AsyncMapping):
                # reference: LoopClosing on its own thread (src/System.cc:105-111)
                self._loop_worker = AsyncLoopClosing(self.loop_closing, self.map_lock)
                self.local_mapping.loop_closer = self._loop_worker
            else:
                self.local_mapping.loop_closer = self.loop_closing
        else:
            self.local_mapping.loop_closer = _DbOnlyRegistrar(self)
        self.local_mapping.relocalizer = Relocalizer(self.map, self.camera, keyframe_db=self.keyframe_db,
                                                     vocabulary=self.vocabulary)
        self.tracking.vocabulary = self.vocabulary

    def _register_keyframes(self):
        """BoW vectors of every good keyframe into the database, id order."""
        for kf in sorted(self.map.good_keyframes(), key=lambda k: k.kf_id):
            words, groups, weights = bow.transform(self.vocabulary, kf.desc, kf.valid, device=self.device)
            kf.bow_vec = bow.bow_vector(words, weights, self.vocabulary.n_words)
            kf.bow_feat_nodes = groups
            self.keyframe_db.add(kf.kf_id, *kf.bow_vec)

    def train_vocabulary_from_map(self, k: int = 8, depth: int = 3) -> bool:
        """Train a vocabulary on the good keyframes' descriptors (at least
        500), wire place recognition and register the keyframes."""
        descs = [kf.desc[kf.valid] for kf in self.map.good_keyframes()]
        if not descs or sum(len(d) for d in descs) < 500:
            return False
        self.vocabulary = bow.train_vocabulary(np.concatenate(descs), k=k, depth=depth, device=self.device)
        self._wire_place_recognition()
        self._register_keyframes()
        return True

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

    def _begin_frame(self, timestamp: float):
        if self.tracer is not None:
            self.tracer.begin_frame(Frame._next_id, timestamp)

    def _track_locked(self, frame: Frame):
        # async mapping: the keyframe an earlier frame queued is taken up by
        # the mapping worker before this frame takes the map lock
        if isinstance(self.local_mapping, AsyncMapping):
            self.local_mapping.wait_taken()
        with span(self.tracer, "tracking"), self.map_lock:
            state = self.tracking.track_frame(frame)
        if self.tracer is not None:
            self.tracer.end_frame(state=self.tracking.state.name, inliers=self.tracking.n_last_inliers)
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
        self._begin_frame(timestamp)
        with span(self.tracer, "extract"):
            frame = self._make_frame(self._image(image), timestamp)
        state = self._track_locked(frame)
        return frame.t_cw.copy() if state == TrackingState.OK else None

    def track_rgbd(self, image, depth, timestamp: float):
        """-> Tcw (4, 4) float32, or None if the frame was not tracked."""
        if self.sensor != Sensor.RGBD:
            raise ValueError(f"track_rgbd on a {self.sensor.name} system")
        self._begin_frame(timestamp)
        with span(self.tracer, "extract"):
            frame = self._make_frame(self._image(image), timestamp)
            self._attach_depth(frame, depth)
        state = self._track_locked(frame)
        return frame.t_cw.copy() if state == TrackingState.OK else None

    def track_stereo(self, image_left, image_right, timestamp: float):
        """Rectified stereo pair -> Tcw (4, 4) float32, or None."""
        if self.sensor != Sensor.STEREO:
            raise ValueError(f"track_stereo on a {self.sensor.name} system")
        self._begin_frame(timestamp)
        left = self._image(image_left)
        with span(self.tracer, "extract"):
            frame = self._make_frame(left, timestamp)
        with span(self.tracer, "stereo_match"):
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

    def _gba(self):
        return None if self.loop_closing is None else self.loop_closing.gba

    def _drain_mapping(self):
        """Wait for the mapping queue, then the loop queue, then a running
        global BA, and raise the first thing any of them raised. Never call
        it holding map_lock: the workers and global BA's write-back take it."""
        def waits():  # each looked up in its turn: the mapping queue's lazy
            # trainer may start the loop worker and global BA meanwhile
            yield getattr(self.local_mapping, "wait_idle", None)
            yield None if self._loop_worker is None else self._loop_worker.wait_idle
            yield None if self._gba() is None else self._gba().wait

        self._run_all(waits())

    @staticmethod
    def _run_all(calls):
        """Call each of `calls` (None skipped) even after one raised; then
        raise the first exception."""
        errors = []
        for call in calls:
            if call is not None:
                try:
                    call()
                except Exception as exc:
                    errors.append(exc)
        if errors:
            raise errors[0]

    def reset(self):
        if self._gba() is not None:
            self._gba().abort()
        self._drain_mapping()
        # materialize the tracked-so-far trajectories into absolute poses
        # before the map (and its reference keyframes) is dropped
        self._archived_trajectory = self.frame_trajectory()
        self._archived_kf_trajectory = self.keyframe_trajectory()
        self._install_map(self._new_map(), [])
        self.tracking.state = TrackingState.NOT_INITIALIZED
        if self.keyframe_db is not None:
            self.keyframe_db.clear()
            self.map.erase_hooks.append(self.keyframe_db.erase)

    def _new_map(self) -> Map:
        m = Map(device=self.device, index=self.index)
        m.tracer = self.tracer
        return m

    def _install_map(self, m: Map, trajectory):
        """Point every consumer at map `m` and drop the tracker's per-map state."""
        m.tracer = self.tracer
        self.map = m
        self.local_mapping.map = m
        self.local_mapping.recent_points = []
        t = self.tracking
        t.map = m
        t.last_frame = None
        t.velocity = None
        t.trajectory = trajectory
        t.init_ref_frame = None
        t.vo_mode = False
        t._prev_local_pids = None  # stale pids index the old map
        t._pack_cache.clear()  # a new map's pt_version restarts
        if self.local_mapping.relocalizer is not None:
            self.local_mapping.relocalizer.map = m
        if self.loop_closing is not None:
            self.loop_closing.map = m
            self.loop_closing.gba.map = m

    def shutdown(self):
        """Drain the queues and global BA, then end and join the async
        workers (reference System::Shutdown); raise the first thing a worker
        or global BA raised."""
        def stops():  # the loop worker looked up after the drain, which may start it
            yield self._drain_mapping
            yield getattr(self.local_mapping, "shutdown", None)
            yield None if self._loop_worker is None else self._loop_worker.shutdown

        self._run_all(stops())

    def activate_localization_mode(self):
        """Track against the frozen map: no keyframes, no mapping (reference
        System::ActivateLocalizationMode, src/System.cc:147-172)."""
        self.tracking.localization_only = True
        self.local_mapping.paused = True
        self._drain_mapping()

    def deactivate_localization_mode(self):
        self.tracking.localization_only = False
        self.tracking.vo_mode = False
        self.local_mapping.paused = False

    def change_calibration(self, camera: Camera):
        """Swap the camera intrinsics in every consumer and drop the motion
        model, so the next frame re-anchors through the reference keyframe
        (reference Tracking::ChangeCalibration, src/Tracking.cc:1735-1764)."""
        self._drain_mapping()
        self.camera = camera
        self.tracking.camera = camera
        self.local_mapping.camera = camera
        if self.local_mapping.relocalizer is not None:
            self.local_mapping.relocalizer.camera = camera
        if self.loop_closing is not None:
            self.loop_closing.camera = camera
            self.loop_closing.gba.camera = camera
        self.tracking.velocity = None

    def save_map(self, path: str):
        """Checkpoint the map, the frame trajectory and the vocabulary (npz,
        the JAX package's keys) after any running global BA."""
        self._drain_mapping()
        _save_map(self.map, path, vocabulary=self.vocabulary, trajectory=self.tracking.trajectory)

    def load_map(self, path: str):
        """Replace the map with a checkpoint; the System comes up LOST and
        relocalizes against it on the next frame."""
        if self._gba() is not None:
            self._gba().abort()
        self._drain_mapping()
        m, voc, traj = _load_map(path, self.cfg.scale_factor, self.cfg.n_levels, self.camera, device=self.device,
                                 index=self.index)
        self._install_map(m, traj)
        self.tracking.state = TrackingState.LOST
        if voc is not None:
            self.vocabulary = voc
        if self.vocabulary is not None:
            self._wire_place_recognition()
            self._register_keyframes()

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
        """[(timestamp, Tcw)] through the (BA- and loop-corrected) reference
        keyframe poses, after any running global BA; erased keyframes are
        traversed via their stored pose relative to their spanning-tree
        parent (reference SaveTrajectoryTUM)."""
        self._drain_mapping()
        return self._frame_trajectory_now()

    def _frame_trajectory_now(self):
        """frame_trajectory() from the poses as they stand, without waiting
        for the mapping pipeline: for the threaded viewer, which holds
        `map_lock`, which the workers and global BA's write-back need."""
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
