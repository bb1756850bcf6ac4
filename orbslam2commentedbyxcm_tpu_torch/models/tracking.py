"""Tracking: the per-frame pose-estimation state machine on torch tensors.

Counterpart of orbslam2commentedbyxcm_tpu/models/tracking.py (reference
src/Tracking.cc). The device programs: `project_and_match`
(SearchByProjection, src/ORBmatcher.cc:61 with the IsInFrustum gates of
src/Frame.cc:412-477), `match_and_optimize_step` and `fused_track_step`
(motion-model stage chained into the local-map stage, reference
TrackWithMotionModel src/Tracking.cc:966 + TrackLocalMap :1038). Every one
runs on the device its tensors lie on; `pose_optimization` launches the CUDA
pose kernel for CUDA tensors.

`Tracking` is the host state machine: initialization from depth (stereo /
RGB-D) or from two views (monocular: `search_for_initialization`,
`initialize_two_view`, the median-depth scale and `LocalMapping.initial_ba`),
the fused steady-state step with the staged fallback (motion model with the
widened retry, reference keyframe, local map), relocalization when LOST, the
localization-only mode with its visual-odometry fallback on temporal depth
points, the device-side pack cache, and the keyframe policy. With a
vocabulary the reference-keyframe stage first tries a BoW search
(`_track_ref_kf_bow`); relocalization runs through the local mapper's
`relocalizer` (models/relocalization), as in the JAX package.

Two places take the correct behavior where the JAX package has a known fault:
the fused step's local pack resolves replaced points and drops invalid ones
(the JAX package packs its previous local set as is, tracking.py:691), and
the fused step bumps the points' visible/found counters only once its
min_localmap_inliers gate has passed (the JAX package bumps them before the
gate, so a bail-out to the staged path counts the frame twice, :725-745).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.models.frame import Frame
from orbslam2commentedbyxcm_tpu_torch.models.map import Map
from orbslam2commentedbyxcm_tpu_torch.ops import bow, matching, twoview
from orbslam2commentedbyxcm_tpu_torch.ops.optim import pose_optimization
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.tracing import count, span

LOCAL_POINT_CAP = 4096


class TrackingState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackingConfig:
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    min_init_matches: int = 60
    min_track_inliers: int = 10
    min_localmap_inliers: int = 30
    kf_tracked_ratio: float = 0.9
    motion_search_radius: float = 15.0
    localmap_search_radius: float = 4.0
    depth_th: float = 35.0  # close/far stereo threshold in baseline units
    # gain-normalize images before FAST (ops/orb ORBExtractor.normalize_exposure)
    normalize_exposure: bool = True
    exposure_target_mad: float = 18.0


def project_and_match(
    pt_xyz, pt_desc, pt_normal, pt_dmin, pt_dmax, pt_mask,
    t_cw, feat_uv, feat_desc, feat_level, feat_valid,
    fx, fy, cx, cy, width, height,
    radius_base, max_dist, log_scale, n_levels,
    pt_angle=None, feat_angle=None,
):
    """Projection-gated search: returns per-feature (point_slot int32, dist,
    ok, visible-per-point).

    Gates: depth z > 0.05, inside the image, distance band, viewing angle
    < 60 deg, predicted scale level +-1, per-level search radius. The best
    point per feature is the first minimum (torch.argmin, as jnp.argmin).
    With `pt_angle`/`feat_angle` the orientation-delta histogram filter is
    applied. A point chosen by several features keeps only the lowest
    (distance, feature index).

    Batched over targets: `t_cw` (B, 4, 4) with `feat_*` carrying the same
    leading B searches one point set against B frames at once (the mapping
    stage's fuse); every output then has that leading dim."""
    r = t_cw[..., :3, :3]
    pc = pt_xyz @ r.transpose(-1, -2) + t_cw[..., None, :3, 3]
    z = pc[..., 2]
    z_ok = z > 0.05
    zs = torch.where(z_ok, z, 1.0)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height)

    if t_cw.dim() == 2:
        cam_center = -r.T @ t_cw[:3, 3]
    else:
        cam_center = -(r.transpose(-1, -2) @ t_cw[..., :3, 3:])[..., 0]
    po = pt_xyz - cam_center[..., None, :]
    dist = torch.sqrt(torch.sum(po * po, dim=-1))
    band = (dist >= 0.8 * pt_dmin) & (dist <= 1.2 * pt_dmax)
    n_norm = torch.sqrt(torch.sum(pt_normal * pt_normal, dim=-1))
    cos_view = torch.sum(po * pt_normal, dim=-1) / torch.clamp(dist * n_norm, min=1e-9)
    view_ok = cos_view > 0.5

    pred_level = torch.clamp(
        torch.ceil(torch.log(torch.clamp(pt_dmax / torch.clamp(dist, min=1e-9), min=1e-9)) / log_scale),
        0, n_levels - 1,
    ).int()
    scale = torch.exp(pred_level.float() * log_scale)
    radius = radius_base * torch.where(cos_view > 0.998, 0.7, 1.0) * scale

    visible = pt_mask & z_ok & in_img & band & view_ok

    # window + level gates, point-major (..., P, N)
    duv = torch.maximum(
        torch.abs(u[..., :, None] - feat_uv[..., None, :, 0]),
        torch.abs(v[..., :, None] - feat_uv[..., None, :, 1]),
    )
    lvl = feat_level[..., None, :]
    lvl_ok = (lvl >= pred_level[..., :, None] - 1) & (lvl <= pred_level[..., :, None] + 1)
    cand = visible[..., :, None] & (duv <= radius[..., :, None]) & lvl_ok & feat_valid[..., None, :]

    d = torch.where(cand, matching.hamming_matrix(pt_desc, feat_desc), matching.BIG)
    best_pt = torch.argmin(d, dim=-2)  # first minimum per feature
    best_d = torch.amin(d, dim=-2)
    ok = (best_d <= max_dist) & feat_valid
    if pt_angle is not None and feat_angle is not None:
        if t_cw.dim() != 2:
            raise ValueError("project_and_match: the rotation filter takes one target")
        ok = matching.rotation_consistency(feat_angle, pt_angle, best_pt, ok)

    # uniqueness: a point picked by several features keeps the one with the
    # lowest distance, ties to the lower feature index
    feat_iota = torch.arange(feat_desc.shape[-2], dtype=torch.float32, device=d.device)
    key = torch.where(ok, best_d + feat_iota * 1e-5, torch.inf)
    point_min = torch.full(d.shape[:-1], torch.inf, device=d.device).scatter_reduce(
        -1, best_pt, key, reduce="amin")
    ok = ok & (key <= point_min.gather(-1, best_pt))
    return best_pt.int(), best_d, ok, visible


def match_and_optimize_step(
    pt_xyz, pt_desc, pt_normal, pt_dmin, pt_dmax, pt_mask,
    t_pred, feat_uv, feat_desc, feat_level, feat_valid,
    existing_mask, existing_xyz,
    obs, inv_sigma2,
    fx, fy, cx, cy, width, height, bf,
    radius_base, max_dist, log_scale, n_levels,
    pt_angle=None, feat_angle=None,
):
    """One tracking stage: projection search + motion-only pose optimization.
    Features with a pre-existing map point (`existing_mask`) keep it and
    always join the optimization."""
    best_pt, best_d, ok, visible = project_and_match(
        pt_xyz, pt_desc, pt_normal, pt_dmin, pt_dmax, pt_mask,
        t_pred, feat_uv, feat_desc, feat_level, feat_valid,
        fx, fy, cx, cy, width, height,
        radius_base, max_dist, log_scale, n_levels,
        pt_angle=pt_angle, feat_angle=feat_angle,
    )
    ok = ok & ~existing_mask
    use = existing_mask | ok
    pt_w = torch.where(existing_mask[:, None], existing_xyz, pt_xyz[best_pt.long()])
    res = pose_optimization(t_pred, pt_w, obs, use, inv_sigma2, fx, fy, cx, cy, bf)
    return best_pt, ok, visible, res.t_cw, res.inliers, res.n_inliers


def fused_track_step(
    m_xyz, m_desc, m_normal, m_dmin, m_dmax, m_mask, m_angle,
    l_xyz, l_desc, l_normal, l_dmin, l_dmax, l_mask,
    t_pred, feat_uv, feat_desc, feat_level, feat_valid, feat_angle,
    obs, inv_sigma2,
    fx, fy, cx, cy, width, height, bf,
    radius_motion, radius_local, max_dist, log_scale, n_levels,
):
    """Both steady-state stages in one call: search against the last frame's
    points (m_*) + pose solve, then search against the local-map pack (l_*)
    from the motion-stage pose + pose solve. Two pose-kernel launches, no host
    read in between."""
    best1, d1, ok1, vis1 = project_and_match(
        m_xyz, m_desc, m_normal, m_dmin, m_dmax, m_mask,
        t_pred, feat_uv, feat_desc, feat_level, feat_valid,
        fx, fy, cx, cy, width, height,
        radius_motion, max_dist, log_scale, n_levels,
        pt_angle=m_angle, feat_angle=feat_angle,
    )
    exist_xyz = m_xyz[best1.long()]
    res1 = pose_optimization(t_pred, exist_xyz, obs, ok1, inv_sigma2, fx, fy, cx, cy, bf)
    exist = ok1 & res1.inliers

    best2, d2, ok2, vis2 = project_and_match(
        l_xyz, l_desc, l_normal, l_dmin, l_dmax, l_mask,
        res1.t_cw, feat_uv, feat_desc, feat_level, feat_valid,
        fx, fy, cx, cy, width, height,
        radius_local, max_dist, log_scale, n_levels,
    )
    ok2 = ok2 & ~exist
    use = exist | ok2
    pt_w = torch.where(exist[:, None], exist_xyz, l_xyz[best2.long()])
    res2 = pose_optimization(res1.t_cw, pt_w, obs, use, inv_sigma2, fx, fy, cx, cy, bf)
    return (best1, exist, vis1, res1.n_inliers,
            best2, ok2, vis2, use, res2.t_cw, res2.inliers, res2.n_inliers)


def _to_numpy(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


class Tracking:
    def __init__(self, camera: Camera, world_map: Map, local_mapper=None,
                 config: TrackingConfig | None = None, std_capacity: int | None = None):
        self.camera = camera
        self.map = world_map
        self.local_mapper = local_mapper
        self.cfg = config or TrackingConfig()
        # the standard extractor's capacity: monocular initialization frames
        # extracted with a larger budget are compacted to it
        self.std_capacity = std_capacity
        self.vocabulary = None  # set by the System when place recognition is wired
        self.tracer = None  # set by the System; "track_device" spans end in a host read
        self.n_kf_deferred = 0  # keyframes the queue-cap gate deferred (the tracer's kf_refused_queue)

        self.state = TrackingState.NOT_INITIALIZED
        self.last_frame: Frame | None = None
        self.init_ref_frame: Frame | None = None
        self.velocity: np.ndarray | None = None
        self.ref_kf_id: int = -1
        self.frames_since_kf = 0
        self.localization_only = False
        # visual-odometry fallback of localization-only mode: the last frame
        # tracked < 10 real map points, its pose carried by temporal depth
        # points (reference mbVO, src/Tracking.cc:381)
        self.vo_mode = False
        self._temporal: tuple | None = None  # the last frame's temporal points
        self._last_n_map = 0  # real map points among the last stage's inliers
        # RANSAC draws of the two-view initialization (the JAX package keys
        # jax.random with an attempt counter)
        self.init_generator = torch.Generator(device=world_map.device)
        self.init_generator.manual_seed(0)
        # (timestamp, ref_kf_id, T_frame_relative_to_kf): frame poses are kept
        # relative to their reference keyframe (src/Tracking.cc:534-549), so
        # BA corrections of the keyframe move the saved trajectory too
        self.trajectory: list[tuple[float, int, np.ndarray]] = []
        self.n_last_inliers = 0
        # device-side pack cache keyed on (cap, map.pt_version, pids): the
        # local map changes only at keyframes and BA, so steady-state frames
        # reuse the packed point tensors instead of uploading them again.
        # Whoever swaps in a new Map clears it (System.reset)
        self._pack_cache: dict = {}
        # the previous frame's local-map point set, which arms the fused
        # steady-state step; None forces the staged path, which refreshes it
        self._prev_local_pids: np.ndarray | None = None

    # -- public entry ------------------------------------------------------

    def track_frame(self, frame: Frame) -> TrackingState:
        if self.state == TrackingState.NOT_INITIALIZED:
            if np.any(frame.depth > 0):
                self._stereo_initialization(frame)
            else:
                self._monocular_initialization(frame)
        else:
            self.state = TrackingState.OK if self._track_normal(frame) else TrackingState.LOST
        self.last_frame = frame
        if self.state == TrackingState.OK:
            ref = self.map.keyframes.get(self.ref_kf_id)
            if ref is not None:
                # a frame that became a keyframe is its own reference (Tcr = I
                # in the reference, recorded before LocalMapping runs): here
                # the synchronous local BA and loop correction have already
                # moved the keyframe, and frame.t_cw is the pose from before
                if ref.frame_id == frame.id:
                    t_rel = np.eye(4, dtype=np.float32)
                else:
                    t_rel = frame.t_cw @ np.linalg.inv(ref.t_cw)
                self.trajectory.append((frame.timestamp, self.ref_kf_id, t_rel))
        return self.state

    # -- initialization ----------------------------------------------------

    def _monocular_initialization(self, frame: Frame):
        """Two-view bootstrap (reference MonocularInitialization +
        CreateInitialMapMonocular, src/Tracking.cc:623-813): the first frame
        with enough features becomes the reference; a later one is matched to
        it (levels <= 1, as the JAX package), the H/F RANSAC reconstructs the
        pair, the map is scaled to a median depth of 1 and refined by the
        initial BA."""
        cfg = self.cfg
        if self.init_ref_frame is None:
            if frame.n >= cfg.min_init_matches:
                self.init_ref_frame = frame
            return
        ref = self.init_ref_frame
        if frame.n < cfg.min_init_matches:
            self.init_ref_frame = None
            return

        def view(fr):
            d = fr.device_arrays()
            return SimpleNamespace(uv=d["uv_und"], desc=d["desc"], level=d["level"], angle=d["angle"],
                                   valid=d["valid"])

        fa, fb = view(ref), view(frame)
        idx, _, ok = matching.search_for_initialization(fa, fb, window=100.0, max_level=1)
        ok_np = ok.cpu().numpy()
        if ok_np.sum() < cfg.min_init_matches:
            self.init_ref_frame = frame
            return
        res = twoview.initialize_two_view(
            self.init_generator, torch.where(ok[:, None], fa.uv, 0.0), fb.uv[idx.long()], ok,
            twoview.k_matrix(self.camera, fa.uv.device))
        if not bool(res.success):
            return

        # the initial map (reference CreateInitialMapMonocular :623)
        t21 = res.t21.cpu().numpy()
        pts = res.points.cpu().numpy()
        tri_ok = res.is_triangulated.cpu().numpy()
        med_depth = float(np.median(pts[tri_ok][:, 2]))
        if med_depth <= 0:
            return
        pts = pts / med_depth
        t21[:3, 3] /= med_depth
        ref.set_pose(np.eye(4, dtype=np.float32))
        frame.set_pose(t21)

        idx_np = idx.cpu().numpy().astype(np.int64)
        pairs = [(int(i), int(idx_np[i])) for i in np.nonzero(tri_ok & ok_np)[0]]
        rmap = fmap = None
        std_cap = self.std_capacity or frame.capacity
        if frame.capacity > std_cap:
            # both double-budget frames back to the standard capacity,
            # matched features first, so keyframe arrays keep one shape
            pri_ref = np.zeros(ref.capacity, bool)
            pri_ref[[i for i, _ in pairs]] = True
            pri_fr = np.zeros(frame.capacity, bool)
            pri_fr[[j for _, j in pairs]] = True
            rmap = ref.compact_to(std_cap, pri_ref)
            fmap = frame.compact_to(std_cap, pri_fr)

        kf1 = self.map.add_keyframe(ref)
        kf2 = self.map.add_keyframe(frame)
        self.map.origin_kf_id = kf1.kf_id
        for i, j in pairs:
            ri = i if rmap is None else int(rmap[i])
            fj = j if fmap is None else int(fmap[j])
            if ri < 0 or fj < 0:
                continue
            pid = self.map.add_point(pts[i], ref.desc[ri], kf1.kf_id)
            self.map.add_observation(pid, kf1.kf_id, ri)
            self.map.add_observation(pid, kf2.kf_id, fj)
            frame.map_pt[fj] = pid
            ref.map_pt[ri] = pid
            self.map.update_point_descriptor(pid)
            self.map.update_point_normal_depth(pid)
        self.map.update_connections(kf1)
        self.map.update_connections(kf2)
        if self.local_mapper is not None:
            self.local_mapper.initial_ba(kf1.kf_id, kf2.kf_id)

        self.ref_kf_id = kf2.kf_id
        self.frames_since_kf = 0
        self.velocity = frame.t_cw @ np.linalg.inv(ref.t_cw)
        self.state = TrackingState.OK
        self.init_ref_frame = None

    def _backproject(self, frame: Frame, idx: np.ndarray) -> np.ndarray:
        """Features `idx` + depth -> world points (Frame::UnprojectStereo)."""
        cam = self.camera
        z = frame.depth[idx]
        u, v = frame.uv_und[idx, 0], frame.uv_und[idx, 1]
        pc = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z], -1).astype(np.float32)
        t_wc = np.linalg.inv(frame.t_cw)
        return pc @ t_wc[:3, :3].T + t_wc[:3, 3]

    def _add_depth_points(self, frame: Frame, kf, idx: np.ndarray):
        for i, pw in zip(idx, self._backproject(frame, idx)):
            pid = self.map.add_point(pw, frame.desc[i], kf.kf_id)
            self.map.add_observation(pid, kf.kf_id, int(i))
            frame.map_pt[i] = pid
            self.map.update_point_normal_depth(pid)

    def _stereo_initialization(self, frame: Frame):
        """Direct depth unprojection (reference StereoInitialization,
        src/Tracking.cc:556-615)."""
        if frame.n < self.cfg.min_init_matches:
            return
        frame.set_pose(np.eye(4, dtype=np.float32))
        kf = self.map.add_keyframe(frame)
        self.map.origin_kf_id = kf.kf_id
        self._add_depth_points(frame, kf, np.nonzero((frame.depth > 0) & frame.valid)[0])
        self.map.update_connections(kf)
        self.ref_kf_id = kf.kf_id
        self.frames_since_kf = 0
        self.velocity = np.eye(4, dtype=np.float32)
        self.state = TrackingState.OK

    def _spawn_depth_points(self, frame: Frame, kf):
        """Close map points from depth at keyframe creation (reference
        CreateNewKeyFrame, src/Tracking.cc:1219-1266: every point closer than
        ThDepth, at least the 100 closest)."""
        cam = self.camera
        th = self.cfg.depth_th * cam.b if cam.b > 0 else self.cfg.depth_th
        cands = np.nonzero((frame.depth > 0) & frame.valid & (frame.map_pt < 0))[0]
        order = cands[np.argsort(frame.depth[cands])]
        keep = order[(frame.depth[order] <= th) | (np.arange(len(order)) < 100)]
        self._add_depth_points(frame, kf, keep)

    # -- steady-state tracking --------------------------------------------

    def _track_normal(self, frame: Frame) -> bool:
        if self.localization_only:
            return self._track_localization_only(frame)
        # steady state: one fused step for both stages; any gate miss leaves
        # the frame untouched and falls through to the staged path
        if (self.velocity is not None and self.state == TrackingState.OK
                and self._prev_local_pids is not None and len(self._prev_local_pids) > 0
                and self._track_fused(frame)):
            self._finish_frame(frame)
            return True
        ok = False
        if self.velocity is not None and self.state == TrackingState.OK:
            ok = self._track_with_motion_model(frame)
        if not ok and self.state == TrackingState.OK:
            ok = self._track_reference_keyframe(frame)
        if not ok and self.state == TrackingState.LOST:
            ok = self._relocalize(frame)
        if not ok:
            return False
        if not self._track_local_map(frame):
            self.velocity = None
            return False
        self._finish_frame(frame)
        return True

    def _track_localization_only(self, frame: Frame) -> bool:
        """Localization-only tracking with the visual-odometry fallback
        (reference Track(), mbOnlyTracking branch, src/Tracking.cc:381-441):
        with enough map matches, track as usual; in VO mode, compute both a
        VO pose from temporal points and a relocalization, and prefer the
        relocalization when it succeeds. No keyframe is made."""
        ok = False
        if self.state == TrackingState.LOST:
            ok = self._relocalize(frame)
            if ok:
                self.vo_mode = False
        elif self.vo_mode:
            ok_vo = False
            vo_pose = vo_map = None
            if self.velocity is not None:
                ok_vo = self._track_with_motion_model(frame)
                vo_pose, vo_map = frame.t_cw.copy(), frame.map_pt.copy()
            if self._relocalize(frame):
                self.vo_mode = False
                ok = True
            elif ok_vo:
                frame.set_pose(vo_pose)
                frame.map_pt = vo_map
                ok = True
        else:
            if self.velocity is not None:
                ok = self._track_with_motion_model(frame)
            if not ok:
                ok = self._track_reference_keyframe(frame)
        if not ok:
            return False
        # local-map refinement only while anchored to the map (ref :449-456)
        if not self.vo_mode and not self._track_local_map(frame):
            self.velocity = None
            return False
        if self.last_frame is not None:
            self.velocity = frame.t_cw @ np.linalg.inv(self.last_frame.t_cw)
        self.frames_since_kf += 1
        return True

    def _finish_frame(self, frame: Frame):
        """Velocity model update (reference :467-502) and keyframe policy."""
        if self.last_frame is not None:
            self.velocity = frame.t_cw @ np.linalg.inv(self.last_frame.t_cw)
        self.frames_since_kf += 1
        if self._need_new_keyframe(frame):
            with span(self.tracer, "kf_create"):
                self._create_new_keyframe(frame)

    def _gather_points(self, pids: np.ndarray, cap: int):
        """Packed point tensors for `pids` on the frame device + slot -> pid,
        cached until the pid set or a packed attribute changes."""
        n = min(len(pids), cap)
        pids = pids[:n]
        key = (cap, self.map.pt_version, pids.tobytes())
        hit = self._pack_cache.get(key)
        if hit is not None:
            return hit
        slot_to_pid = np.full(cap, -1, np.int64)
        slot_to_pid[:n] = pids
        out = (*self.map.pack_points(pids, cap), slot_to_pid)
        # small FIFO: the motion and local-map stages have distinct pid sets;
        # one slot would let the motion set evict the stable local pack
        while len(self._pack_cache) >= 8:
            self._pack_cache.pop(next(iter(self._pack_cache)))
        self._pack_cache[key] = out
        return out

    def _gather_temporal(self, pids: np.ndarray, cap: int, extra):
        """Map points `pids` packed as `_gather_points` does (uncached), then
        the temporal points `extra` = (xyz, desc, normal, dmin, dmax, angle)
        in the slots after them, which map to pid -2: matched, but not a map
        point (localization-only VO, reference UpdateLastFrame
        src/Tracking.cc:893)."""
        n = min(len(pids), cap)
        ne = min(len(extra[0]), cap - n)
        pack = self.map.pack_points(pids, cap)
        for t, a in zip(pack, extra[:5]):
            a = np.ascontiguousarray(a[:ne])
            t[n:n + ne] = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(t.device)
        pack[5][n:n + ne] = True
        slot_to_pid = np.full(cap, -1, np.int64)
        slot_to_pid[:n] = pids[:n]
        slot_to_pid[n:n + ne] = -2
        return (*pack, slot_to_pid)

    def _match_and_optimize(self, frame: Frame, pids, t_pred, radius, cap=LOCAL_POINT_CAP,
                            max_dist=matching.TH_HIGH, keep_existing=False, pt_angle=None, extra=None):
        cfg, cam = self.cfg, self.camera
        if extra is None:
            *pack, slot_to_pid = self._gather_points(pids, cap)
        else:
            *pack, slot_to_pid = self._gather_temporal(pids, cap, extra)
        fdev = frame.device_arrays()
        dev = self.map.device
        angle_args = {}
        if pt_angle is not None:
            ang = np.zeros(cap, np.float32)
            n = min(len(pids), cap)
            ang[:n] = pt_angle[:n]
            if extra is not None:
                ne = min(len(extra[5]), cap - n)
                ang[n:n + ne] = extra[5][:ne]
            angle_args = dict(pt_angle=torch.from_numpy(ang).to(dev), feat_angle=fdev["angle"])
        # pre-existing assignments keep their world point (keep_existing)
        existing_mask = frame.map_pt >= 0 if keep_existing else np.zeros(frame.capacity, bool)
        existing_xyz = np.zeros((frame.capacity, 3), np.float32)
        if existing_mask.any():
            existing_xyz[existing_mask] = self.map.pt_xyz[frame.map_pt[existing_mask]]
        with span(self.tracer, "track_device"):
            out = match_and_optimize_step(
                *pack, torch.from_numpy(np.asarray(t_pred, np.float32)).to(dev),
                fdev["uv_und"], fdev["desc"], fdev["level"], fdev["valid"],
                torch.from_numpy(existing_mask).to(dev), torch.from_numpy(existing_xyz).to(dev),
                fdev["obs"], fdev["inv_sigma2"],
                cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height), cam.bf,
                float(radius), float(max_dist), math.log(cfg.scale_factor), cfg.n_levels,
                **angle_args,
            )
            best_pt, ok, visible, t_cw, inliers, n_inl = _to_numpy(*out)

        matched_pid = np.where(ok, slot_to_pid[best_pt], -1)
        if keep_existing:
            matched_pid = np.where(frame.map_pt >= 0, frame.map_pt, matched_pid)
        frame.map_pt = matched_pid
        # visibility counters (reference mnVisible, src/Tracking.cc:1302-1334)
        vis_pids = slot_to_pid[np.nonzero(visible)[0]]
        self.map.pt_visible[vis_pids[vis_pids >= 0]] += 1
        # -2: a temporal VO point, which constrains the pose but is no map point
        matched = (matched_pid >= 0) | (matched_pid == -2)
        if matched.sum() < 3:
            return 0
        frame.set_pose(t_cw)
        frame.map_pt = np.where(inliers, frame.map_pt, -1)
        frame.is_outlier = matched & ~inliers
        self.map.pt_found[frame.map_pt[frame.map_pt >= 0]] += 1
        # real map inliers, temporal points excluded (nmatchesMap, :1010)
        self._last_n_map = int((frame.map_pt >= 0).sum())
        return int(n_inl)

    def _track_fused(self, frame: Frame) -> bool:
        """One-call steady-state tracking (fused_track_step). Returns True
        and commits the frame on success; returns False with the frame
        untouched so the staged path can run."""
        cfg, cam = self.cfg, self.camera
        lf = self.last_frame
        lf.map_pt = self.map.resolve_replaced_batch(lf.map_pt)
        feats = np.nonzero(lf.map_pt >= 0)[0]
        pids_m, first = np.unique(lf.map_pt[feats], return_index=True)
        if len(pids_m) < 10:
            return False
        local = self.map.resolve_replaced_batch(self._prev_local_pids)
        local = np.unique(local[local >= 0])
        cap = LOCAL_POINT_CAP
        *m_pack, m_slot_to_pid = self._gather_points(pids_m, cap)
        *l_pack, l_slot_to_pid = self._gather_points(local, cap)
        ang = np.zeros(cap, np.float32)
        n_m = min(len(pids_m), cap)
        ang[:n_m] = lf.angle[feats[first]][:n_m]
        fdev = frame.device_arrays()
        dev = self.map.device
        t_pred = (self.velocity @ lf.t_cw).astype(np.float32)
        with span(self.tracer, "track_device"):
            out = fused_track_step(
                *m_pack, torch.from_numpy(ang).to(dev), *l_pack,
                torch.from_numpy(t_pred).to(dev), fdev["uv_und"], fdev["desc"],
                fdev["level"], fdev["valid"], fdev["angle"], fdev["obs"], fdev["inv_sigma2"],
                cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height), cam.bf,
                float(cfg.motion_search_radius), float(cfg.localmap_search_radius),
                float(matching.TH_HIGH), math.log(cfg.scale_factor), cfg.n_levels,
            )
            best1, exist, vis1, n1, best2, ok2, vis2, use, t_cw, inl2, n2 = _to_numpy(*out)
        if int(n1) < 20:
            return False  # the staged path redoes motion with the widened retry
        self.n_last_inliers = int(n2)
        if int(n2) < cfg.min_localmap_inliers:
            return False  # the staged path retries with a fresh local set
        for vis, s2p in ((vis1, m_slot_to_pid), (vis2, l_slot_to_pid)):
            vp = s2p[np.nonzero(vis)[0]]
            self.map.pt_visible[vp[vp >= 0]] += 1
        matched_pid = np.where(exist, m_slot_to_pid[best1], np.where(ok2, l_slot_to_pid[best2], -1))
        frame.map_pt = np.where(inl2, matched_pid, -1)
        frame.is_outlier = use & ~inl2
        frame.set_pose(t_cw)
        self.map.pt_found[frame.map_pt[frame.map_pt >= 0]] += 1
        self._last_n_map = int((frame.map_pt >= 0).sum())
        # refresh the local set for the next frame (also sets ref_kf_id, as
        # the staged path's UpdateLocalKeyFrames does)
        local_kfs = self._local_keyframes(frame)
        self._prev_local_pids = self.map.points_seen_by(local_kfs) if local_kfs else None
        return True

    def _update_last_frame_temporal(self):
        """Temporal 3-D points from the last frame's close stereo / RGB-D
        depth, so localization-only VO survives unmapped regions (reference
        UpdateLastFrame, src/Tracking.cc:893-960: the closest 100, or all
        closer than ThDepth)."""
        lf = self.last_frame
        self._temporal = None
        if lf is None or not np.any(lf.depth > 0):
            return
        cam = self.camera
        th = self.cfg.depth_th * cam.b if cam.b > 0 else self.cfg.depth_th
        sel = np.nonzero((lf.depth > 0) & lf.valid & (lf.map_pt < 0))[0]
        if len(sel) == 0:
            return
        order = sel[np.argsort(lf.depth[sel])]
        keep = order[(lf.depth[order] <= th) | (np.arange(len(order)) < 100)]
        t_wc = np.linalg.inv(lf.t_cw)
        z = lf.depth[keep]
        u, v = lf.uv_und[keep, 0], lf.uv_und[keep, 1]
        pc = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z], -1)
        pw = pc @ t_wc[:3, :3].T + t_wc[:3, 3]
        d = np.linalg.norm(pw - lf.center, axis=-1)
        sf = lf.scale_factor
        dmax = d * sf ** lf.level[keep]
        dmin = dmax / sf ** (lf.n_levels - 1)
        normal = (pw - lf.center) / np.maximum(d[:, None], 1e-9)
        self._temporal = (pw.astype(np.float32), lf.desc[keep], normal.astype(np.float32),
                          dmin.astype(np.float32), dmax.astype(np.float32), lf.angle[keep].astype(np.float32))

    def _track_with_motion_model(self, frame: Frame) -> bool:
        lf = self.last_frame
        lf.map_pt = self.map.resolve_replaced_batch(lf.map_pt)  # CheckReplacedInLastFrame
        feats = np.nonzero(lf.map_pt >= 0)[0]
        pids, first = np.unique(lf.map_pt[feats], return_index=True)
        # per-point source angle for the orientation-consistency histogram
        pt_angle = lf.angle[feats[first]].astype(np.float32)
        extra = None
        if self.localization_only:
            self._update_last_frame_temporal()
            extra = self._temporal
        if len(pids) < 10 and extra is None:
            return False
        t_pred = (self.velocity @ lf.t_cw).astype(np.float32)
        frame.set_pose(t_pred)
        n = self._match_and_optimize(frame, pids, t_pred, self.cfg.motion_search_radius,
                                     pt_angle=pt_angle, extra=extra)
        if n < 20:
            # widened retry (src/Tracking.cc:986-993): clear the assignments
            # and search again with twice the window
            frame.map_pt[:] = -1
            frame.is_outlier[:] = False
            frame.set_pose(t_pred)
            n = self._match_and_optimize(frame, pids, t_pred, 2.0 * self.cfg.motion_search_radius,
                                         pt_angle=pt_angle, extra=extra)
        if self.localization_only:
            # VO mode when the pose rests on < 10 real map points (ref :1010)
            self.vo_mode = self._last_n_map < 10
            return n >= 20
        return n >= self.cfg.min_track_inliers

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """BoW search against the reference keyframe when a vocabulary is
        wired (SearchByBoW, src/Tracking.cc:850), else a wide-window
        projection search."""
        kf = self.map.keyframes.get(self.ref_kf_id)
        if kf is None:
            return False
        pids = np.unique(kf.map_pt[kf.map_pt >= 0])
        if len(pids) < 10:
            return False
        t_pred = self.last_frame.t_cw if self.last_frame is not None else kf.t_cw
        frame.set_pose(t_pred.astype(np.float32))
        if self._track_ref_kf_bow(frame, kf):
            return True
        n = self._match_and_optimize(frame, pids, frame.t_cw, radius=30.0)
        return n >= self.cfg.min_track_inliers

    def _track_ref_kf_bow(self, frame: Frame, kf) -> bool:
        """BoW-node matching of the frame to the keyframe's map points (ratio
        0.7, mutual, rotation histogram), then one pose solve on them."""
        if self.vocabulary is None or kf.bow_feat_nodes is None:
            return False
        fdev = frame.device_arrays()
        dev = fdev["desc"].device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        _, groups, _ = bow.transform(self.vocabulary, fdev["desc"], frame.valid)
        idx, _, ok = matching.search_by_bow(
            fdev["desc"], t(groups), fdev["valid"],
            t(kf.desc.view(np.int32)), t(kf.bow_feat_nodes.astype(np.int32)), t(kf.valid & (kf.map_pt >= 0)),
            angle_a=fdev["angle"], angle_b=t(kf.angle), ratio=0.7)
        ok, idx = ok.cpu().numpy(), idx.cpu().numpy()
        matched_pid = np.where(ok, kf.map_pt[idx], -1)
        if (matched_pid >= 0).sum() < 15:
            return False
        frame.map_pt = matched_pid
        matched = matched_pid >= 0
        pt_w = np.zeros((frame.capacity, 3), np.float32)
        pt_w[matched] = self.map.pt_xyz[matched_pid[matched]]
        cam = self.camera
        res = pose_optimization(t(frame.t_cw), t(pt_w), fdev["obs"], t(matched), fdev["inv_sigma2"],
                                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        frame.set_pose(res.t_cw.cpu().numpy())
        inliers = res.inliers.cpu().numpy()
        frame.map_pt = np.where(inliers, frame.map_pt, -1)
        frame.is_outlier = matched & ~inliers
        self._last_n_map = int((frame.map_pt >= 0).sum())
        return int(res.n_inliers) >= self.cfg.min_track_inliers

    def _relocalize(self, frame: Frame) -> bool:
        reloc = getattr(self.local_mapper, "relocalizer", None)
        return reloc is not None and reloc.relocalize(frame, self)

    def _local_keyframes(self, frame: Frame, cap: int = 80) -> list[int]:
        """Covisibility expansion around the frame's matched points
        (UpdateLocalKeyFrames, src/Tracking.cc:1391); sets ref_kf_id."""
        pids = np.unique(frame.map_pt[frame.map_pt >= 0])
        if len(pids) == 0:
            return []
        _, kf_arr, _ = self.map._observer_csr(pids)
        if len(kf_arr) == 0:
            return []
        kf_ids, counts = np.unique(kf_arr, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        local = [int(kf_ids[i]) for i in order[:cap]]
        extra = []
        for kf_id in local[: cap // 2]:
            kf = self.map.keyframes.get(kf_id)
            if kf is not None and not kf.bad:
                extra.extend(kf.best_covisible(10))
        seen = set(local)
        for e in extra:
            if e not in seen and len(local) < cap:
                local.append(e)
                seen.add(e)
        self.ref_kf_id = local[0]
        return local

    def _track_local_map(self, frame: Frame) -> bool:
        local_kfs = self._local_keyframes(frame)
        if not local_kfs:
            return False
        pids = self.map.points_seen_by(local_kfs)
        if len(pids) == 0:
            return False
        n = self._match_and_optimize(frame, pids, frame.t_cw, self.cfg.localmap_search_radius,
                                     keep_existing=True)
        self.n_last_inliers = n
        self._prev_local_pids = pids  # arms the fused step for the next frame
        return n >= self.cfg.min_localmap_inliers

    # -- keyframe policy ---------------------------------------------------

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Reference NeedNewKeyFrame (src/Tracking.cc:1088-1186). A mapper
        with `accepts_keyframes()` (the async pipeline's AsyncMapping) that
        refuses has its local BA interrupted, and the keyframe waits for a
        later frame; the synchronous mapper always accepts."""
        cfg = self.cfg
        kf = self.map.keyframes.get(self.ref_kf_id)
        if kf is None:
            return False
        n_kfs = len(self.map.good_keyframes())
        min_obs = 3 if n_kfs > 2 else 2
        ref_pids = np.unique(kf.map_pt[kf.map_pt >= 0])
        ref_matches = 0
        if len(ref_pids):
            pid_idx, _, _ = self.map._observer_csr(ref_pids)
            ref_matches = int((np.bincount(pid_idx, minlength=len(ref_pids)) >= min_obs).sum())

        # close-point pressure, stereo/RGB-D only (src/Tracking.cc:1119-1134)
        is_depth = bool(np.any(frame.depth > 0))
        need_close = False
        if is_depth:
            b = self.camera.b if self.camera.b > 0 else 1.0
            close = (frame.depth > 0) & (frame.depth < cfg.depth_th * b) & frame.valid
            n_tracked_close = int(np.sum(close & (frame.map_pt >= 0)))
            n_untracked_close = int(np.sum(close & (frame.map_pt < 0)))
            need_close = n_tracked_close < 100 and n_untracked_close > 70

        ratio = cfg.kf_tracked_ratio if n_kfs > 2 else 0.4
        inl = self.n_last_inliers
        # c1a hard timeout, c1b min-interval gate, c1c stereo/RGB-D pressure,
        # c2 quality drop. As in the JAX package, the hard timeout inserts
        # unconditionally (the reference requires c2 as well)
        c1a = self.frames_since_kf >= cfg.max_frames_between_kf
        c1b = self.frames_since_kf >= cfg.min_frames_between_kf
        c1c = is_depth and (inl < ref_matches * 0.25 or need_close)
        c2 = (inl < ref_matches * ratio or need_close) and inl > 15
        if not (c1a or ((c1b or c1c) and c2)):
            return False
        # keyframe wanted: a busy mapper has its local BA interrupted and the
        # keyframe is deferred (src/Tracking.cc:1160-1181: InterruptBA while
        # local mapping is not idle, insert while the queue is short)
        accepts = getattr(self.local_mapper, "accepts_keyframes", None)
        if accepts is not None and not accepts():
            interrupt = getattr(self.local_mapper, "interrupt_ba", None)
            if interrupt is not None:
                interrupt()
            self.n_kf_deferred += 1
            count(self.tracer, "kf_refused_queue")
            return False
        return True

    def _create_new_keyframe(self, frame: Frame):
        kf = self.map.add_keyframe(frame)
        kf.map_pt[:] = -1  # rebuilt strictly from accepted observations
        seen = set()
        for i in np.nonzero(frame.map_pt >= 0)[0]:
            pid = int(frame.map_pt[i])
            if pid not in seen and self.map.pt_valid[pid]:
                seen.add(pid)
                self.map.add_observation(pid, kf.kf_id, int(i))
        if seen:
            touched = np.fromiter(seen, np.int64)
            self.map.update_point_descriptors_batch(touched)
            self.map.update_points_batch(touched)
        if np.any(frame.depth > 0):
            self._spawn_depth_points(frame, kf)
        self.map.update_connections(kf)
        self.ref_kf_id = kf.kf_id
        self.frames_since_kf = 0
        # the new keyframe re-centers the local map: the next frame runs the
        # staged path, which refreshes the fused step's local set
        self._prev_local_pids = None
        count(self.tracer, "kf_inserted")
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf.kf_id)
