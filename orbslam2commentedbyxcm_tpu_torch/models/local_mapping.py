"""LocalMapping: map growth + local bundle adjustment, run synchronously per
keyframe insertion.

Counterpart of orbslam2commentedbyxcm_tpu/models/local_mapping.py (reference
src/LocalMapping.cc):

  MapPointCulling (:185)      -> found-ratio < 0.25 / observation thresholds
  CreateNewMapPoints (:235)   -> epipolar-gated Hamming matching + batched DLT
                                 triangulation with the chi2 / parallax /
                                 scale gates, all neighbors in one batch
  SearchInNeighbors (:506)    -> projection matching into every target at once
                                 (a leading target dimension) + host merge
  Local BA (:75)              -> ops/optim.bundle_adjustment, 5 + 10 rounds,
                                 the abort flag polled between the two (the
                                 reference's mbAbortBA)
  KeyFrameCulling (:708)      -> 90%-redundancy rule
  initial_ba                  -> 20 LM iterations over the two-keyframe map of
                                 a monocular initialization, the first fixed
                                 (CreateInitialMapMonocular's global BA)

After mapping, each keyframe goes to `loop_closer.insert_keyframe` when one is
set (models/loop_closing, the lazy vocabulary trainer or the place-recognition
registrar of models/system); `paused` (localization mode) skips mapping and
the hand-off alike.

The interruption hooks of the reference's LocalMapping thread serve the
async pipeline (models/async_pipeline, which runs this stage on a worker):
`abort_ba` (mbAbortBA) is raised by a new keyframe's insertion and by
`interrupt_ba()`, and stops the local BA after its first phase;
`pending_check` (set by AsyncMapping: more keyframes queued) defers fuse,
local BA and keyframe culling, the CheckNewKeyFrames() gates of the
reference's Run loop. In the synchronous pipeline neither ever fires.
`tracer` (utils/tracing) records the JAX package's spans, and counts the
local BAs deferred (`ba_deferred`) and stopped after their first phase
(`ba_aborted`). `loop_closing` times the loop closer where it runs in this
thread; a hand-off to the async loop worker is a queue put, and that
worker's own spans time its work.

Device work runs on the map's device; host bookkeeping stays numpy. The JAX
package pads every array to a power-of-two size so XLA compiles each shape
once; torch needs no padding, so the arrays here have their true sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.models.async_pipeline import AsyncLoopClosing
from orbslam2commentedbyxcm_tpu_torch.models.frame import KeyFrame, level_sigma2
from orbslam2commentedbyxcm_tpu_torch.models.map import Map
from orbslam2commentedbyxcm_tpu_torch.models.tracking import project_and_match
from orbslam2commentedbyxcm_tpu_torch.ops import matching, optim
from orbslam2commentedbyxcm_tpu_torch.ops.twoview import triangulate
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.tracing import count, span


def _homogeneous(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def epipolar_match(desc1, uv1, free1, desc2, uv2, free2, f12, sigma2_lvl2, epipole2, max_dist):
    """Triangulation matching (SearchForTriangulation, src/ORBmatcher.cc:850):
    the free features of KF1 against the free features of a batch of B
    neighbors, gated by the epipolar line in each neighbor.

    desc1/uv1/free1 are KF1's (N1, ...); the rest carry a leading B.
    Returns per (B, N1): (best neighbor feature, distance, ok)."""
    lines = _homogeneous(uv1) @ f12.transpose(-1, -2)        # (B, N1, 3)
    num = torch.abs(lines @ _homogeneous(uv2).transpose(-1, -2))  # (B, N1, N2)
    den = torch.sqrt(torch.clamp(lines[..., 0:1] ** 2 + lines[..., 1:2] ** 2, min=1e-12))
    epi_ok = num / den < 3.84 * torch.sqrt(sigma2_lvl2)[:, None, :]
    # reject features too close to the epipole (ref :925-938, scale-dependent)
    de2 = torch.sum((uv2 - epipole2[:, None, :]) ** 2, dim=-1)
    far_from_epipole = de2 > 100.0 * sigma2_lvl2
    cand = free1[None, :, None] & free2[:, None, :] & epi_ok & far_from_epipole[:, None, :]
    d = torch.where(cand, matching.hamming_matrix(desc1, desc2), matching.BIG)
    return torch.argmin(d, dim=-1), torch.amin(d, dim=-1) <= max_dist


def triangulate_and_check(
    t1, t2, uv1n, uv2n, uv1, uv2, ur1, ur2, depth1, depth2, mask,
    sigma2_1, sigma2_2, scale1, scale2, fx, fy, cx, cy, bf, baseline,
):
    """Batched DLT triangulation + acceptance gates (CreateNewMapPoints,
    src/LocalMapping.cc:373-503): parallax, cheirality, reprojection chi2
    (5.991 mono / 7.8 stereo), scale-distance consistency.

    View 1 (KF1: t1 (4, 4), per-feature (N,) arrays) is shared; view 2 has a
    leading B (t2 (B, 4, 4), (B, N) arrays). Source selection mirrors the
    reference (:346-460) with its else-if: the parallax comes from the
    unprojected keypoint rays; when view 1 has depth its stereo parallax
    gates triangulation and view 2's stays at cosParallaxRays + 1."""
    b = t2.shape[0]
    r1, tr1 = t1[:3, :3], t1[:3, 3]
    r2, tr2 = t2[:, :3, :3], t2[:, :3, 3]
    o1 = -r1.T @ tr1
    o2 = -(r2.transpose(-1, -2) @ tr2[..., None])[..., 0]
    pts_tri = triangulate(t1[:3].expand(b, 3, 4), t2[:, :3], uv1n.expand(b, -1, -1), uv2n)

    # world direction of normalized pixel xn is R_wc @ [xn, 1]
    ray1 = _homogeneous(uv1n) @ r1
    ray2 = _homogeneous(uv2n) @ r2
    cos_par = torch.sum(ray1 * ray2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(ray1, dim=-1) * torch.linalg.vector_norm(ray2, dim=-1), min=1e-12)

    def stereo_cos(depth):
        return torch.cos(2.0 * torch.atan2(torch.full_like(depth, baseline / 2.0), depth))

    stereo1, stereo2 = depth1 > 0, depth2 > 0
    cos_st1 = torch.where(stereo1, stereo_cos(depth1), cos_par + 1.0)
    cos_st2 = torch.where(~stereo1 & stereo2, stereo_cos(depth2), cos_par + 1.0)
    cos_st = torch.minimum(cos_st1, cos_st2)
    use_tri = (cos_par > 0.0) & (cos_par < cos_st) & (stereo1 | stereo2 | (cos_par < 0.9998))
    use_d1 = ~use_tri & stereo1 & (cos_st1 < cos_st2)
    # reference :452-460: view 2 needs strictly better stereo parallax
    use_d2 = ~use_tri & ~use_d1 & stereo2 & (cos_st2 < cos_st1)

    def backproject(uv, depth, r, t3):
        pc = torch.stack([(uv[..., 0] - cx) / fx * depth, (uv[..., 1] - cy) / fy * depth, depth], -1)
        return (pc - t3) @ r  # R^T (pc - t) per row

    pts = torch.where(
        use_tri[..., None], pts_tri,
        torch.where(use_d1[..., None], backproject(uv1, depth1, r1, tr1),
                    backproject(uv2, depth2, r2, tr2[:, None, :])),
    )
    pc1 = pts @ r1.T + tr1
    pc2 = pts @ r2.transpose(-1, -2) + tr2[:, None, :]
    n1 = torch.linalg.vector_norm(pts - o1, dim=-1)
    n2 = torch.linalg.vector_norm(pts - o2[:, None, :], dim=-1)

    def reproj_ok(pc, uv, ur, sigma2):
        zs = torch.clamp(pc[..., 2], min=1e-6)
        u = fx * pc[..., 0] / zs + cx
        v = fy * pc[..., 1] / zs + cy
        e2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
        stereo = ur >= 0
        eur = torch.where(stereo, (u - zs.new_tensor(bf) / zs) - ur, 0.0) ** 2
        return (e2 + eur) / sigma2 < torch.where(stereo, 7.8, 5.991)

    ok1 = reproj_ok(pc1, uv1, ur1, sigma2_1)
    ok2 = reproj_ok(pc2, uv2, ur2, sigma2_2)
    # scale-distance consistency (ratioDist vs octave ratio within 1.5x)
    ratio_dist = n2 / torch.clamp(n1, min=1e-12)
    ratio_octave = scale1 / torch.clamp(scale2, min=1e-12)
    factor = 1.5 * 1.2
    scale_ok = (ratio_dist < ratio_octave * factor) & (ratio_dist * factor > ratio_octave)
    good = (mask & (use_tri | use_d1 | use_d2) & (pc1[..., 2] > 0) & (pc2[..., 2] > 0)
            & ok1 & ok2 & scale_ok & torch.isfinite(pts).all(dim=-1))
    return pts, good


def mapping_triangulate_fused(
    kf_desc, kf_uv, kf_free, kf_t, kf_ur, kf_depth, kf_sig2, kf_scale,
    desc2, uv2_all, level2, free2, f12_b, sig2_b, epi_b, t2_b, ur2_all, d2_all,
    kinv, scale_factor, max_dist, fx, fy, cx, cy, bf, baseline,
):
    """The whole triangulation stage over the stacked neighbor batch (leading
    B): epipolar matching, gathers of the matched neighbor features, batched
    DLT + acceptance gates. Returns (best (B, N), ok, pts (B, N, 3), good)."""
    best, ok = epipolar_match(kf_desc, kf_uv, kf_free, desc2, uv2_all, free2,
                              f12_b, sig2_b, epi_b, max_dist)
    uv2 = torch.take_along_dim(uv2_all, best[..., None], dim=1)
    ur2, d2, sig2g = (torch.gather(a, 1, best) for a in (ur2_all, d2_all, sig2_b))
    scale2 = scale_factor ** torch.gather(level2, 1, best).float()

    def norm(uv):
        xn = _homogeneous(uv) @ kinv.T
        return xn[..., :2] / xn[..., 2:3]

    pts, good = triangulate_and_check(
        kf_t, t2_b, norm(kf_uv), norm(uv2), kf_uv, uv2, kf_ur, ur2, kf_depth, d2, ok,
        kf_sig2, sig2g, kf_scale, scale2, fx, fy, cx, cy, bf, baseline,
    )
    return best, ok, pts, good


class LocalMapping:
    def __init__(self, world_map: Map, camera: Camera, loop_closer=None,
                 n_triangulation_neighbors: int = 10):
        self.map = world_map
        self.camera = camera
        self.loop_closer = loop_closer
        self.relocalizer = None  # set by the System once place recognition is wired
        self.paused = False
        self.n_tri_neighbors = n_triangulation_neighbors
        self.recent_points: list[tuple[int, int]] = []  # (pid, created-at kf_id)
        self.tracer = None
        # == reference mbAbortBA (src/LocalMapping.cc:75): raised by a new
        # keyframe's insertion or interrupt_ba(); the local BA polls it
        # between its phases
        self.abort_ba = False
        # set by AsyncMapping: "more keyframes are queued" (CheckNewKeyFrames)
        self.pending_check = None
        self.n_local_ba = 0      # local BA solves run so far
        self.n_ba_aborted = 0    # of those, stopped after their first phase
        self.n_ba_deferred = 0   # keyframes whose BA was skipped for newer ones

    def _tensor(self, a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.map.device)

    def interrupt_ba(self):
        """== reference LocalMapping::InterruptBA (src/Tracking.cc:1168)."""
        self.abort_ba = True

    def _more_pending(self) -> bool:
        return self.pending_check is not None and self.pending_check()

    # -- entry point -------------------------------------------------------

    def initial_ba(self, kf1_id: int, kf2_id: int):
        """BA over the two-keyframe initial map, kf1 fixed (reference
        CreateInitialMapMonocular runs GlobalBundleAdjustemnt(20))."""
        m = self.map
        problem = assemble_ba_problem(m, [kf1_id, kf2_id], fixed_ids={kf1_id})
        if problem is None:
            return
        write_back_ba(m, problem, solve_ba_problem(problem, self.camera, m.device, INITIAL_BA_SCHEDULE))

    def insert_keyframe(self, kf_id: int):
        if self.paused:
            return
        kf = self.map.keyframes[kf_id]
        if kf.bad:
            # culled while it waited in the async queue (tracking links a new
            # keyframe into the covisibility graph at once, so an older
            # keyframe's culling can reach it); the JAX worker maps it anyway
            return
        with span(self.tracer, "local_mapping"):
            self._track_recent_points(kf)
            self.cull_map_points(kf)
            self.create_new_map_points(kf)
            # reference Run loop (src/LocalMapping.cc:63-82): fuse, local BA
            # and culling wait while newer keyframes are queued, so the worker
            # catches up first; mbAbortBA resets before the BA
            if not self._more_pending():
                self.fuse_neighbors(kf)
            self.abort_ba = False
            if self._more_pending():
                self.n_ba_deferred += 1
                count(self.tracer, "ba_deferred")
            else:
                with span(self.tracer, "local_ba"):
                    self.local_bundle_adjustment(kf)
                with span(self.tracer, "map_host_cull"):
                    self.cull_keyframes(kf)
        if isinstance(self.loop_closer, AsyncLoopClosing):
            self.loop_closer.insert_keyframe(kf_id)
        elif self.loop_closer is not None:
            with span(self.tracer, "loop_closing"):
                self.loop_closer.insert_keyframe(kf_id)

    # -- recent-point culling ---------------------------------------------

    def _track_recent_points(self, kf: KeyFrame):
        for pid in kf.map_pt[kf.map_pt >= 0]:
            if self.map.pt_first_kf[pid] == kf.kf_id:
                self.recent_points.append((int(pid), kf.kf_id))

    def cull_map_points(self, kf: KeyFrame):
        """MapPointCulling (src/LocalMapping.cc:185-220)."""
        m = self.map
        kept = []
        for pid, born_kf in self.recent_points:
            if not m.pt_valid[pid]:
                continue
            age = kf.kf_id - born_kf
            if m.pt_found[pid] / max(int(m.pt_visible[pid]), 1) < 0.25:
                m.erase_point(pid)
            elif age >= 2 and m.n_observations(pid) <= 2:
                m.erase_point(pid)
            elif age < 3:
                kept.append((pid, born_kf))  # still on probation
        self.recent_points = kept

    # -- triangulation -----------------------------------------------------

    def create_new_map_points(self, kf: KeyFrame):
        cam = self.camera
        k_mat = cam.K
        kinv = np.linalg.inv(k_mat)
        sigma2 = level_sigma2(kf.n_levels, kf.scale_factor)

        # host-side neighbor gating + per-neighbor epipolar geometry
        nbs, f12s, epipoles = [], [], []
        for nb_id in kf.best_covisible(self.n_tri_neighbors):
            nb = self.map.keyframes.get(nb_id)
            if nb is None or nb.bad:
                continue
            baseline = np.linalg.norm(nb.center - kf.center)
            med_depth = self._scene_median_depth(nb)
            if med_depth <= 0 or baseline / med_depth < 0.01:
                continue
            # fundamental matrix KF -> neighbor (ComputeF12, :606-626)
            t21 = nb.t_cw @ np.linalg.inv(kf.t_cw)
            r21, tt21 = t21[:3, :3], t21[:3, 3]
            tx = np.array([[0, -tt21[2], tt21[1]], [tt21[2], 0, -tt21[0]], [-tt21[1], tt21[0], 0]])
            f12s.append((kinv.T @ tx @ r21 @ kinv).astype(np.float32))
            # epipole of kf's camera center in the neighbor image
            c_in_nb = nb.t_cw[:3, :3] @ kf.center + nb.t_cw[:3, 3]
            if abs(c_in_nb[2]) < 1e-6:
                epipoles.append(np.array([1e6, 1e6], np.float32))
            else:
                epipoles.append((k_mat @ (c_in_nb / c_in_nb[2]))[:2].astype(np.float32))
            nbs.append(nb)
        if not nbs:
            self.map.update_connections(kf)
            return

        def stack(get, dtype):
            return self._tensor(np.stack([get(nb) for nb in nbs]), dtype)

        free_kf = (kf.map_pt < 0) & kf.valid
        with span(self.tracer, "map_device"):
            best, ok, pts, good = mapping_triangulate_fused(
                self._tensor(kf.desc.view(np.int32)), self._tensor(kf.uv_und), self._tensor(free_kf),
                self._tensor(kf.t_cw), self._tensor(kf.u_right), self._tensor(kf.depth),
                self._tensor(sigma2[kf.level], np.float32),
                self._tensor(kf.scale_factor ** kf.level, np.float32),
                stack(lambda nb: nb.desc.view(np.int32), None), stack(lambda nb: nb.uv_und, np.float32),
                stack(lambda nb: nb.level, np.int32), stack(lambda nb: (nb.map_pt < 0) & nb.valid, None),
                self._tensor(np.stack(f12s)), stack(lambda nb: sigma2[nb.level], np.float32),
                self._tensor(np.stack(epipoles)), stack(lambda nb: nb.t_cw, np.float32),
                stack(lambda nb: nb.u_right, np.float32), stack(lambda nb: nb.depth, np.float32),
                self._tensor(kinv, np.float32), float(kf.scale_factor), float(matching.TH_LOW),
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.b,
            )
            best, pts, good = (t.cpu().numpy() for t in (best, pts, good))
        created = []
        with span(self.tracer, "map_host_create"):
            for b, nb in enumerate(nbs):
                for i in np.nonzero(good[b])[0]:
                    if kf.map_pt[i] >= 0 or nb.map_pt[best[b, i]] >= 0:
                        continue  # taken earlier in this batch
                    pid = self.map.add_point(pts[b, i], kf.desc[i], kf.kf_id)
                    self.map.add_observation(pid, kf.kf_id, int(i))
                    self.map.add_observation(pid, nb.kf_id, int(best[b, i]))
                    self.recent_points.append((pid, kf.kf_id))
                    created.append(pid)
        if created:
            with span(self.tracer, "map_host_ptbatch"):
                self.map.update_point_descriptors_batch(created)
                self.map.update_points_batch(created)
        with span(self.tracer, "map_host_connections"):
            self.map.update_connections(kf)

    def _scene_median_depth(self, kf: KeyFrame) -> float:
        """KeyFrame::ComputeSceneMedianDepth (src/KeyFrame.cc:682)."""
        pids = kf.map_pt[kf.map_pt >= 0]
        if len(pids) == 0:
            return -1.0
        z = self.map.pt_xyz[pids] @ kf.t_cw[2, :3] + kf.t_cw[2, 3]
        return float(np.median(z))

    # -- fusion ------------------------------------------------------------

    def _merge_matches(self, target: KeyFrame, pids: np.ndarray, best_pt, ok, touched: list):
        """Duplicate merge for one target keyframe (the Fuse resolution of
        src/ORBmatcher.cc:1067): a feature that already observes another point
        -> replace the point with fewer observations; a free feature -> add
        the observation. Points that gained one are appended to `touched`."""
        feat = np.nonzero(ok)[0]
        if len(feat) == 0:
            return
        with span(self.tracer, "map_host_merge"):
            m = self.map
            pid = pids[best_pt[feat]]
            keep = m.pt_valid[pid]
            feat, pid = feat[keep], pid[keep]
            existing = target.map_pt[feat]
            has_existing = (existing >= 0) & m.pt_valid[np.maximum(existing, 0)]
            # conflicts, sequentially: an earlier replace may invalidate a later pid
            for p, ex in zip(pid[has_existing], existing[has_existing]):
                p, ex = int(p), int(ex)
                if p == ex or not m.pt_valid[p] or not m.pt_valid[ex]:
                    continue
                if m.n_observations(ex) >= m.n_observations(p):
                    m.replace_point(p, ex)
                else:
                    m.replace_point(ex, p)
            # free features (re-check: a replace above may have re-pointed the slot)
            for f, p in zip(feat[~has_existing], pid[~has_existing]):
                p = int(p)
                now = int(target.map_pt[f])
                if now >= 0 and m.pt_valid[now]:
                    continue
                if not m.pt_valid[p] or target.kf_id in m.obs.get(p, ()):
                    continue
                m.add_observation(p, target.kf_id, int(f))
                touched.append(p)

    def _search(self, pids: np.ndarray, targets: list[KeyFrame]):
        """project_and_match of points `pids` into `targets` (a leading target
        dim) -> numpy (best_pt (B, N), ok (B, N))."""
        t0 = targets[0]
        if any(t.n_levels != t0.n_levels or t.scale_factor != t0.scale_factor for t in targets):
            raise ValueError("fuse targets must share one extractor pyramid config")
        cam = self.camera

        def stack(name, dtype=None):
            return self._tensor(np.stack([getattr(t, name) for t in targets]), dtype)

        with span(self.tracer, "map_device"):
            best_pt, _, ok, _ = project_and_match(
                *self.map.pack_points(pids, len(pids)),
                stack("t_cw", np.float32), stack("uv_und", np.float32),
                self._tensor(np.stack([t.desc for t in targets]).view(np.int32)),
                stack("level", np.int32), stack("valid"),
                cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height),
                3.0, float(matching.TH_LOW), math.log(t0.scale_factor), t0.n_levels,
            )
            return best_pt.cpu().numpy(), ok.cpu().numpy()

    def fuse_neighbors(self, kf: KeyFrame):
        """SearchInNeighbors (src/LocalMapping.cc:506-603): project-and-fuse
        both ways with the 1st/2nd-degree covisible neighbors. The forward
        direction (kf's points into every target) is one batched search."""
        first = kf.best_covisible(self.n_tri_neighbors)
        targets = set(first)
        for f in first:
            fkf = self.map.keyframes.get(f)
            if fkf is not None:
                targets.update(fkf.best_covisible(5))
        targets.discard(kf.kf_id)
        t_list = [t for t_id in sorted(targets)
                  if (t := self.map.keyframes.get(t_id)) is not None and not t.bad]
        touched: list = []
        kf_pids = np.unique(kf.map_pt[kf.map_pt >= 0])
        kf_pids = kf_pids[self.map.pt_valid[kf_pids]]
        if t_list and len(kf_pids):
            best_pt, ok = self._search(kf_pids, t_list)
            for b, target in enumerate(t_list):
                self._merge_matches(target, kf_pids, best_pt[b], ok[b], touched)
        # reverse direction: the neighbors' points into kf
        nb_pids = self.map.points_seen_by(targets)
        if len(nb_pids):
            best_pt, ok = self._search(nb_pids, [kf])
            self._merge_matches(kf, nb_pids, best_pt[0], ok[0], touched)
        if touched:
            with span(self.tracer, "map_host_ptbatch"):
                self.map.update_point_descriptors_batch(touched)
                self.map.update_points_batch(touched)
        with span(self.tracer, "map_host_connections"):
            self.map.update_connections(kf)

    # -- keyframe culling --------------------------------------------------

    def cull_keyframes(self, kf: KeyFrame):
        """KeyFrameCulling (src/LocalMapping.cc:708-775): a local keyframe is
        redundant if > 90% of its points are seen by >= 3 other keyframes at
        the same or a finer scale."""
        m = self.map
        for kf_id in kf.best_covisible():
            c = m.keyframes.get(kf_id)
            if c is None or c.bad or c.kf_id == m.origin_kf_id:
                continue
            feats = np.nonzero(c.map_pt >= 0)[0]
            pids = c.map_pt[feats]
            valid = m.pt_valid[pids]
            feats, pids = feats[valid], pids[valid]
            if len(pids) == 0:
                continue
            pid_idx, kf_arr, ft_arr = m._observer_csr(pids)
            other = kf_arr != kf_id
            lv_rows = np.full(len(kf_arr), 1 << 30, np.int64)
            for k in np.unique(kf_arr[other]):
                o = m.keyframes.get(int(k))
                if o is not None:
                    sel = kf_arr == k
                    lv_rows[sel] = o.level[ft_arr[sel]]
            better = other & (lv_rows <= c.level[feats][pid_idx] + 1)
            n_better = np.bincount(pid_idx[better], minlength=len(pids))
            if int((n_better >= 3).sum()) > 0.9 * len(pids):
                m.erase_keyframe(kf_id)

    # -- local BA ----------------------------------------------------------

    def local_bundle_adjustment(self, kf: KeyFrame):
        """BA over kf + its covisible keyframes and their points, with the
        second ring fixed (reference LocalBundleAdjustment). The abort flag is
        polled between LOCAL_BA_SCHEDULE's phases, as the reference checks
        pbStopFlag between its 5- and 10-iteration optimizes
        (src/Optimizer.cc:720-737); write-back and outlier erasure run on the
        partial result, as its recovery section does."""
        m = self.map
        local_set = [i for i in dict.fromkeys([kf.kf_id] + kf.best_covisible())
                     if i in m.keyframes and not m.keyframes[i].bad]
        with span(self.tracer, "map_host_assemble"):
            problem = assemble_ba_problem(m, local_set)
        if problem is None:
            return
        phases = []

        def abort_check():
            phases.append(self.abort_ba)
            return self.abort_ba

        with span(self.tracer, "map_device"):
            res = solve_ba_problem(problem, self.camera, m.device, abort_check=abort_check)
            out = (res.poses.cpu().numpy(), res.points.cpu().numpy(), res.obs_inliers.cpu().numpy())
        self.n_local_ba += 1
        if any(phases):
            self.n_ba_aborted += 1
            count(self.tracer, "ba_aborted")
        with span(self.tracer, "map_host_writeback"):
            write_back_ba(m, problem, res, out)


def assemble_ba_problem(m: Map, local_set, fixed_ids=None):
    """BA arrays for `local_set` keyframes + their points, with second-ring
    observers and the origin keyframe (or else `fixed_ids`) as fixed poses
    (reference LocalBundleAdjustment vertex setup, src/Optimizer.cc:556-650).
    None when the problem is too small."""
    pids = m.points_seen_by(local_set)
    if len(pids) < 8 or len(local_set) == 0:
        return None
    pid_idx, kf_arr, ft_arr = m._observer_csr(pids)
    uniq_kf = np.unique(kf_arr)
    uniq_kf = uniq_kf[np.fromiter((int(k) in m.keyframes for k in uniq_kf), bool, count=len(uniq_kf))]
    ring2 = set(int(k) for k in uniq_kf) - set(local_set)
    all_ids = list(local_set) + sorted(ring2)
    fixed = ring2 | ({m.origin_kf_id} if fixed_ids is None else set(fixed_ids))
    if not any(i in fixed for i in all_ids):  # gauge: at least one fixed pose
        fixed.add(all_ids[0])
    kf_slot = {kf_id: s for s, kf_id in enumerate(all_ids)}
    poses = np.stack([m.keyframes[k].t_cw for k in all_ids]).astype(np.float32)
    pose_fixed = np.array([k in fixed for k in all_ids])

    # kf_id -> pose slot through a sorted lookup; edges to unknown kfs drop out
    ids_arr = np.asarray(all_ids, np.int64)
    order = np.argsort(ids_arr)
    pos = np.minimum(np.searchsorted(ids_arr[order], kf_arr), len(ids_arr) - 1)
    in_graph = ids_arr[order][pos] == kf_arr
    pid_idx, kf_arr, ft_arr, pos = pid_idx[in_graph], kf_arr[in_graph], ft_arr[in_graph], pos[in_graph]
    ne = len(pid_idx)
    if ne < 8:
        return None
    obs_uvr = np.empty((ne, 3), np.float32)
    obs_sig = np.empty(ne, np.float32)
    for k in np.unique(kf_arr):
        sel = kf_arr == k
        okf = m.keyframes[int(k)]
        ft = ft_arr[sel]
        obs_uvr[sel, :2] = okf.uv_und[ft]
        obs_uvr[sel, 2] = okf.u_right[ft]
        obs_sig[sel] = okf.inv_sigma2()[ft]
    return {
        "kf_slot": kf_slot, "pids": pids, "poses": poses, "pose_fixed": pose_fixed,
        "points": m.pt_xyz[pids].copy(), "point_valid": np.ones(len(pids), bool),
        "op": order[pos].astype(np.int64), "opt": pid_idx.astype(np.int64),
        "ouv": obs_uvr, "osig": obs_sig, "omask": np.ones(ne, bool),
        # edge provenance for outlier erasure (kf id, pid, feat idx)
        "obs_kf": kf_arr, "obs_pid": pids[pid_idx], "obs_ft": ft_arr,
    }


LOCAL_BA_SCHEDULE = ((5, True), (10, True))  # (LM iterations, Huber) per phase
INITIAL_BA_SCHEDULE = ((20, True),)


def solve_ba_problem(problem, cam: Camera, device, schedule=LOCAL_BA_SCHEDULE, abort_check=None,
                     relabel_between: bool = True):
    """The BA solve of an assembled problem on `device`.

    Without `abort_check` the phases of `schedule` run in one
    `bundle_adjustment` call. With it, each phase is its own call and
    `abort_check()` is polled between them; when it fires, the remaining
    phases are skipped and the partial result returned (g2o's force-stop,
    the reference's mbAbortBA / mbStopGBA). The next phase starts from the
    relabeled inliers, relabeled against the full mask as in one call.
    Local BA polls its abort flag (mbAbortBA), global BA (models/gba) its
    stop event."""
    t = {k: torch.from_numpy(problem[k]).to(device)
         for k in ("poses", "pose_fixed", "points", "point_valid", "op", "opt", "ouv", "omask", "osig")}
    intr = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    if abort_check is None:
        return optim.bundle_adjustment(
            t["poses"], t["pose_fixed"], t["points"], t["point_valid"], t["op"], t["opt"], t["ouv"],
            t["omask"], t["osig"], *intr, schedule=schedule, relabel_between=relabel_between)
    poses, points, active, res = t["poses"], t["points"], None, None
    for i, phase in enumerate(schedule):
        res = optim.bundle_adjustment(
            poses, t["pose_fixed"], points, t["point_valid"], t["op"], t["opt"], t["ouv"], t["omask"],
            t["osig"], *intr, schedule=(phase,), relabel_between=relabel_between, active_init=active)
        poses, points = res.poses, res.points
        if relabel_between:
            active = res.obs_inliers
        if i + 1 < len(schedule) and abort_check():
            break
    return res


def write_back_ba(m: Map, problem, res, host=None):
    """Optimized poses/points into the map, outlier observations erased
    (reference LocalBundleAdjustment recovery, :816-855). `host` is the
    result already read to numpy (poses, points, inliers)."""
    out_poses, out_points, inl = host or (res.poses.cpu().numpy(), res.points.cpu().numpy(),
                                          res.obs_inliers.cpu().numpy())
    pids = problem["pids"]
    for kf_id, s in problem["kf_slot"].items():
        if not problem["pose_fixed"][s]:
            kf = m.keyframes.get(kf_id)
            if kf is not None:
                kf.set_pose(out_poses[s])
    m.pt_xyz[pids] = out_points
    m.pt_version += 1  # direct pt_xyz write: invalidates tracking's pack cache
    for e in np.nonzero(~inl)[0]:
        m.erase_observation(int(problem["obs_pid"][e]), int(problem["obs_kf"][e]))
    m.update_points_batch(pids)
