"""Loop closing: detection, Sim3 computation, correction, essential graph and
global BA.

Counterpart of orbslam2commentedbyxcm_tpu/models/loop_closing.py (reference
src/LoopClosing.cc):

  DetectLoop (:101)    BoW candidates gated by the minimum covisible score
                       and 3-consecutive-group consistency
  ComputeSim3 (:236)   all candidates' KF <-> KF matching in one batch, their
                       Sim3 RANSAC (Horn) in one batch, then per survivor
                       SearchBySim3 match growing (src/ORBmatcher.cc:1361)
                       and the Sim3 refinement (>= 20 inliers), then a
                       Sim3-guided projection search (>= 40 matches)
  CorrectLoop (:448)   Sim3 propagated to the covisible group, points
                       remapped and fused (the loop point wins),
                       LoopConnections (:595), the essential graph
                       (ops/posegraph) and a transient abortable global BA
                       (models/gba, the reference's GBA thread, :634)

With a shard mesh (`mesh=`, parallel/mesh.ShardMesh) an essential graph of
at least `dist_min_vertices` keyframes is solved edge-sharded over it
(parallel/dist_posegraph, counted in `stats["posegraph_distributed"]`), and
global BA gets the mesh too (models/gba).

Device work (ops/sim3solver, ops/posegraph, the projection matcher of
models/tracking) runs on the map's device; the host keeps the group
bookkeeping and the graph edges. The JAX package pads every batch to a
power-of-two size for XLA; here the arrays have their true sizes, and a
candidate batch is padded only to its longest member.

A keyframe goes through three phases, as in the JAX package:
`detect_candidates`, `try_close` (the batched matching, RANSAC, growth and
refinement: the expensive part, almost always a rejection) and `finalize`
(the guided gate, the correction, the database registration).
`process_prepared` runs them back to back; the async pipeline's loop worker
(models/async_pipeline) runs `try_close` without the map lock on a
`snapshot_for_closure` (frozen copies of what it reads, `_MapView` /
`_KFView`) taken under the lock, so the mapping worker can change the map
meanwhile.

`last_split` holds the host-clock seconds of the pieces of the last
processed keyframe (each piece ends in a host read), `closure_splits` those
of every keyframe that closed a loop, with the essential graph's size and LM
iterations.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.models.frame import KeyFrame, level_sigma2
from orbslam2commentedbyxcm_tpu_torch.models.gba import GlobalBA
from orbslam2commentedbyxcm_tpu_torch.models.tracking import project_and_match
from orbslam2commentedbyxcm_tpu_torch.ops import bow, matching, posegraph, sim3solver
from orbslam2commentedbyxcm_tpu_torch.ops.twoview import draw_samples
from orbslam2commentedbyxcm_tpu_torch.parallel.system_bridge import solve_pose_graph_dist


def _sim3_to_se3(m: np.ndarray) -> np.ndarray:
    """De-scale a Sim3 to an SE3 pose (R, t/s), as CorrectLoop writes Sim3
    results back (:445-449)."""
    s = float(np.linalg.norm(np.asarray(m)[:3, 0]))
    t_cw = np.eye(4, dtype=np.float32)
    t_cw[:3, :3] = np.asarray(m)[:3, :3] / s
    t_cw[:3, 3] = np.asarray(m)[:3, 3] / s
    return t_cw


def _sim3_of(kf) -> np.ndarray:
    """A keyframe's SE3 pose as a scale-1 Sim3 (the 4x4 itself)."""
    return np.asarray(kf.t_cw, np.float32)


class _MapView:
    """Frozen copies of the point arrays the Sim3 phase reads, taken under the
    map lock; the mapping worker goes on changing the live arrays while
    `try_close` runs on these."""

    def __init__(self, m):
        n = m.n_points
        self.pt_xyz = m.pt_xyz[:n].copy()
        self.pt_valid = m.pt_valid[:n].copy()
        self.pt_desc = m.pt_desc[:n].copy()
        self.pt_dmax = m.pt_dmax[:n].copy()


class _KFView:
    """A keyframe with frozen copies of `map_pt` and `t_cw`; its feature
    arrays (uv, descriptors, levels, BoW nodes), which never change, pass
    through to the live keyframe."""

    def __init__(self, kf):
        self._kf = kf
        self.kf_id = kf.kf_id
        self.map_pt = kf.map_pt.copy()
        self.t_cw = kf.t_cw.copy()

    def __getattr__(self, k):
        return getattr(self._kf, k)


def match_candidates(a_desc, a_nodes, c_desc, c_nodes, c_valid, use_bow, max_dist=matching.TH_LOW,
                     ratio: float = 0.75):
    """KF <-> KF matching of one query keyframe's rows (M, 8) against a batch
    of C candidates' rows (C, T, 8), each candidate by its own rule: BoW
    grouping-node gated (SearchByBoW, src/ORBmatcher.cc:696) where
    `use_bow[c]`, plain Hamming where not; both mutual nearest neighbours
    with the 0.75 ratio test and TH_LOW. Returns (idx (C, M), ok (C, M))."""
    d = matching.hamming_matrix(a_desc, c_desc)                            # (C, M, T)
    gate = (a_nodes[None, :, None] == c_nodes[:, None, :]) & (a_nodes >= 0)[None, :, None]
    gate = torch.where(use_bow[:, None, None], gate, True) & c_valid[:, None, :]
    d = torch.where(gate, d, matching.BIG)
    best = torch.argmin(d, dim=2)
    best_d = torch.amin(d, dim=2)
    cols = torch.arange(d.shape[2], device=d.device)
    second = torch.amin(torch.where(cols == best[..., None], matching.BIG, d), dim=2)
    ok = (best_d <= max_dist) & (best_d < ratio * second)
    rev = torch.argmin(d, dim=1)                                           # (C, T)
    ok = ok & (torch.gather(rev, 1, best) == torch.arange(d.shape[1], device=d.device))
    return best, ok


class LoopClosing:
    CAND_CAP = 5  # consistent candidates tried per keyframe (the reference tries all, one by one)

    def __init__(self, world_map, camera, map_lock, keyframe_db=None, vocabulary=None, fix_scale: bool = False,
                 covisibility_consistency_th: int = 3, device=None, mesh=None, dist_min_vertices: int = 256):
        self.map = world_map
        self.camera = camera
        self.db = keyframe_db
        self.voc = vocabulary
        self.fix_scale = fix_scale
        self.consistency_th = covisibility_consistency_th
        self.device = world_map.device if device is None else torch.device(device)
        self.prev_consistent_groups: list[tuple[set, int]] = []
        self.last_loop_kf_id = -1
        self.n_loops_closed = 0
        self.stats = {"db_candidates": 0, "consistent": 0, "sim3_tried": 0, "bow_match_fail": 0,
                      "ransac_fail": 0, "refine_fail": 0, "sim3_ok": 0, "guided_fail": 0,
                      "cooldown_skip": 0, "posegraph_distributed": 0}
        # per-candidate cooldown after a geometric rejection: an appearance-
        # similar but geometrically wrong candidate resurfaces on nearly every
        # keyframe; it is skipped for the next few keyframes and retried after
        self._sim3_cooldown: dict[int, int] = {}
        self.sim3_cooldown_kfs = 3
        self.generator = torch.Generator(device=self.device).manual_seed(13)  # RANSAC draws
        self.last_split: dict = {}
        self.closure_splits: list[dict] = []
        # the transient abortable GBA (reference :634) writes back under the
        # map lock
        self.mesh = mesh
        self.dist_min_vertices = dist_min_vertices
        self.gba = GlobalBA(world_map, camera, map_lock, device=self.device, mesh=mesh)

    def _tensor(self, a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

    def _lap(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.last_split[name] = self.last_split.get(name, 0.0) + t - t0
        return t

    # -- entry ---------------------------------------------------------------

    def insert_keyframe(self, kf_id: int):
        kf = self.prepare_keyframe(kf_id)
        if kf is not None:
            self.process_prepared(kf)

    def prepare_keyframe(self, kf_id: int):
        """The keyframe's BoW vector and grouping nodes; None for an erased
        keyframe or without a vocabulary / database. Reads only the
        keyframe's features, which never change: the loop worker runs it
        without the map lock."""
        t0 = time.perf_counter()
        self.last_split = {}
        kf = self.map.keyframes.get(kf_id)
        if kf is None or kf.bad or self.voc is None or self.db is None:
            return None
        words, groups, weights = bow.transform(self.voc, kf.desc, kf.valid, device=self.device)
        kf.bow_vec = bow.bow_vector(words, weights, self.voc.n_words)
        kf.bow_feat_nodes = groups
        self._lap("bow_transform", t0)
        return kf

    def process_prepared(self, kf: KeyFrame):
        """Detection, Sim3, correction, then the keyframe's registration in
        the database, back to back on the live map."""
        candidates = self.detect_candidates(kf)
        found = self.try_close(kf, candidates) if candidates else None
        self.finalize(kf, found)

    def detect_candidates(self, kf: KeyFrame) -> list[int]:
        """Phase 1: the database query and the group consistency. Reads the
        database and the covisibility graph, so it runs under the map lock."""
        t0 = time.perf_counter()
        out = self._detect_loop(kf)
        self._lap("detect", t0)
        return out

    def snapshot_for_closure(self, kf: KeyFrame, candidates: list[int]):
        """Consistent copies of all that `try_close` reads (call under the
        map lock): (_MapView, _KFView of kf, {candidate id: _KFView})."""
        t0 = time.perf_counter()
        m = self.map
        views = {c: _KFView(ck) for c in candidates if (ck := m.keyframes.get(c)) is not None and not ck.bad}
        out = _MapView(m), _KFView(kf), views
        self._lap("snapshot", t0)
        return out

    def try_close(self, kf: KeyFrame, candidates: list[int], snapshot=None):
        """Phase 2: batched matching and Sim3 RANSAC over the candidates, then
        growth and refinement per survivor, on the live map or on a snapshot
        from `snapshot_for_closure` (then without the map lock, as the
        reference runs ComputeSim3 outside the map mutex, which only
        CorrectLoop takes, src/LoopClosing.cc:497). Returns the
        [(cand_id, S_cur_corrected)] survivors in order, or None."""
        if snapshot is None:
            m = self.map
            views = {c: ck for c in candidates if (ck := m.keyframes.get(c)) is not None and not ck.bad}
            return self._compute_sim3_geom(m, kf, views, candidates)
        mv, kfv, views = snapshot
        return self._compute_sim3_geom(mv, kfv, views, candidates)

    def finalize(self, kf: KeyFrame, found) -> None:
        """Phase 3, under the map lock: the guided >= 40 gate and the
        correction for the refined Sim3 survivors in order (a gate failure
        moves on to the next survivor, src/LoopClosing.cc:236-439), then the
        database registration."""
        for cand_id, s_cur_corr in found or ():
            ckf = self.map.keyframes.get(cand_id)
            if ckf is None or ckf.bad or kf.bad:
                continue
            t0 = time.perf_counter()
            loop_pids = self.map.points_seen_by(set(ckf.best_covisible()) | {cand_id})
            self.stats["sim3_ok"] += 1
            n_guided = int((self._guided_matches(kf, s_cur_corr, loop_pids)[0] >= 0).sum())
            self._lap("guided", t0)
            if n_guided >= 40:
                self._correct_loop(kf, cand_id, s_cur_corr, loop_pids)
                break
            self.stats["guided_fail"] += 1
        self.db.add(kf.kf_id, kf.bow_vec[0], kf.bow_vec[1])

    # -- detection -----------------------------------------------------------

    def _detect_loop(self, kf: KeyFrame) -> list[int]:
        # too close to the last loop, or the map too small (reference :108-115)
        if kf.kf_id < self.last_loop_kf_id + 10 or len(self.map.keyframes) < 10:
            return []
        min_score = 1.0
        for nb in kf.best_covisible():
            min_score = min(min_score, self.db.score_vec(kf.bow_vec, nb))
        connected = set(kf.covis) | {kf.kf_id}
        cands = self.db.detect_loop_candidates(kf.kf_id, kf.bow_vec[0], kf.bow_vec[1], min_score,
                                               connected, self.map)
        self.stats["db_candidates"] += len(cands)
        if not cands:
            self.prev_consistent_groups = []
            return []
        # 3-consecutive-group consistency (reference :146-221)
        enough: list[int] = []
        current_groups: list[tuple[set, int]] = []
        for cand in cands:
            ckf = self.map.keyframes.get(cand)
            if ckf is None:
                continue
            group = set(ckf.covis) | {cand}
            best_consistency = 0
            for prev_group, count in self.prev_consistent_groups:
                if group & prev_group:
                    best_consistency = max(best_consistency, count + 1)
            current_groups.append((group, best_consistency))
            if best_consistency >= self.consistency_th:
                enough.append(cand)
        self.prev_consistent_groups = current_groups
        self.stats["consistent"] += len(enough)
        return enough

    # -- Sim3 ----------------------------------------------------------------

    def _compute_sim3_geom(self, m, kf, cand_views: dict, candidates: list[int]):
        """Batched KF <-> KF matching and Sim3 RANSAC over the candidates,
        then SearchBySim3 growth and refinement per RANSAC survivor. `m` is
        the live Map or a _MapView, `cand_views` maps candidate id -> its
        keyframe or _KFView. Returns the [(cand_id, S_cur_corrected)]
        survivors in order, or None."""
        my = None
        batch = []
        for cand_id in candidates[: self.CAND_CAP]:
            if self._sim3_cooldown.get(cand_id, -1) > kf.kf_id:
                self.stats["cooldown_skip"] += 1
                continue
            self.stats["sim3_tried"] += 1
            ckf = cand_views.get(cand_id)
            if ckf is None:
                continue
            if my is None:
                my = np.nonzero(kf.map_pt >= 0)[0]
            their = np.nonzero(ckf.map_pt >= 0)[0]
            if len(my) < 20 or len(their) < 20:
                continue
            batch.append((cand_id, ckf, their))
        if not batch:
            return None

        t0 = time.perf_counter()
        matches = self._match_candidates_batched(kf, my, batch)
        t0 = self._lap("bow_match", t0)
        lvl_sig = level_sigma2(kf.n_levels, kf.scale_factor)
        lanes = []
        for (cand_id, ckf, their), (idx, ok) in zip(batch, matches):
            my_feat, their_feat = my[ok], their[idx[ok]]
            pids1, pids2 = kf.map_pt[my_feat], ckf.map_pt[their_feat]
            good = m.pt_valid[pids1] & m.pt_valid[pids2]
            my_feat, their_feat, pids1, pids2 = my_feat[good], their_feat[good], pids1[good], pids2[good]
            if len(pids1) < 20:
                self.stats["bow_match_fail"] += 1
                self._sim3_cooldown[cand_id] = kf.kf_id + self.sim3_cooldown_kfs
                continue
            p1 = m.pt_xyz[pids1] @ kf.t_cw[:3, :3].T + kf.t_cw[:3, 3]
            p2 = m.pt_xyz[pids2] @ ckf.t_cw[:3, :3].T + ckf.t_cw[:3, 3]
            lanes.append((cand_id, ckf, my_feat, their_feat, p1, p2,
                          lvl_sig[kf.level[my_feat]], lvl_sig[ckf.level[their_feat]]))
        if not lanes:
            return None

        # every surviving candidate's RANSAC in one batch, padded to the longest
        n = max(len(lane[4]) for lane in lanes)
        c = len(lanes)
        p1b, p2b = np.zeros((c, n, 3), np.float32), np.zeros((c, n, 3), np.float32)
        maskb = np.zeros((c, n), bool)
        s1b, s2b = np.ones((c, n), np.float32), np.ones((c, n), np.float32)
        for i, (*_, p1, p2, sig1, sig2) in enumerate(lanes):
            k = len(p1)
            p1b[i, :k], p2b[i, :k], maskb[i, :k], s1b[i, :k], s2b[i, :k] = p1, p2, True, sig1, sig2
        mask_t = self._tensor(maskb)
        res = sim3solver.ransac_sim3(
            self._tensor(p1b), self._tensor(p2b), mask_t, self._tensor(self.camera.K, np.float32),
            self._tensor(s1b), self._tensor(s2b), fix_scale=self.fix_scale,
            samples=self._draw_samples(mask_t, 128))
        success, s12_all, inliers_all = (a.cpu().numpy() for a in (res.success, res.s12, res.inliers))
        t0 = self._lap("ransac", t0)

        survivors = []
        for i, (cand_id, ckf, my_feat, their_feat, *_) in enumerate(lanes):
            if not success[i]:
                self.stats["ransac_fail"] += 1
                self._sim3_cooldown[cand_id] = kf.kf_id + self.sim3_cooldown_kfs
                continue
            out = self._grow_and_refine(m, kf, ckf, cand_id, my, np.nonzero(ckf.map_pt >= 0)[0],
                                        my_feat, their_feat, s12_all[i], inliers_all[i], lvl_sig)
            if out is not None:
                survivors.append(out)
        self._lap("grow_refine", t0)
        return survivors or None

    def _draw_samples(self, mask: torch.Tensor, n_hypotheses: int) -> torch.Tensor:
        """(C, n_hypotheses, 3) RANSAC draws from the loop closer's generator."""
        return draw_samples(mask, n_hypotheses, 3, self.generator)

    def _match_candidates_batched(self, kf, my, batch):
        """The query keyframe's point-carrying rows against every candidate's
        in one batch. A candidate whose grouping nodes are known is matched
        through them, one without by plain Hamming, each on its own (the JAX
        package drops the whole batch to plain Hamming when any candidate
        lacks its nodes). Returns [(idx, ok)] per candidate."""
        t = max(len(their) for *_, their in batch)
        c = len(batch)
        c_desc = np.zeros((c, t, 8), np.uint32)
        c_nodes = np.full((c, t), -1, np.int64)
        c_valid = np.zeros((c, t), bool)
        use_bow = np.zeros(c, bool)
        q_bow = kf.bow_feat_nodes is not None
        for i, (_, ckf, their) in enumerate(batch):
            c_desc[i, : len(their)] = ckf.desc[their]
            c_valid[i, : len(their)] = True
            if q_bow and ckf.bow_feat_nodes is not None:
                use_bow[i] = True
                c_nodes[i, : len(their)] = ckf.bow_feat_nodes[their]
        a_nodes = kf.bow_feat_nodes[my] if q_bow else np.full(len(my), -1)
        idx, ok = match_candidates(
            self._tensor(kf.desc[my].view(np.int32)), self._tensor(a_nodes, np.int64),
            self._tensor(c_desc.view(np.int32)), self._tensor(c_nodes), self._tensor(c_valid),
            self._tensor(use_bow))
        idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
        return [(idx[i], ok[i]) for i in range(c)]

    def _grow_and_refine(self, m, kf, ckf, cand_id, my, their, my_feat, their_feat, s12, ransac_inliers, lvl_sig):
        """SearchBySim3 growth + OptimizeSim3 for one RANSAC survivor
        (reference LoopClosing.cc:344-355) -> (cand_id, S_cur_corrected) or
        None (with the cooldown set)."""
        cam = self.camera
        new1, new2 = self._search_by_sim3(m, kf, ckf, s12, my, their, my_feat, their_feat)
        n0 = len(my_feat)
        if len(new1):
            my_feat, their_feat = np.concatenate([my_feat, new1]), np.concatenate([their_feat, new2])
        pids1, pids2 = kf.map_pt[my_feat], ckf.map_pt[their_feat]
        p1 = m.pt_xyz[pids1] @ kf.t_cw[:3, :3].T + kf.t_cw[:3, 3]
        p2 = m.pt_xyz[pids2] @ ckf.t_cw[:3, :3].T + ckf.t_cw[:3, 3]
        inl0 = np.ones(len(pids1), bool)  # grown matches start as inliers
        inl0[:n0] = np.asarray(ransac_inliers)[:n0]
        sig1, sig2 = lvl_sig[kf.level[my_feat]], lvl_sig[ckf.level[their_feat]]
        ref = posegraph.optimize_sim3(
            self._tensor(s12, np.float32), self._tensor(p1, np.float32), self._tensor(p2, np.float32),
            self._tensor(kf.uv_und[my_feat], np.float32), self._tensor(ckf.uv_und[their_feat], np.float32),
            self._tensor(inl0), self._tensor(cam.K, np.float32),
            self._tensor(1.0 / np.maximum(sig1, 1e-6), np.float32),
            self._tensor(1.0 / np.maximum(sig2, 1e-6), np.float32), fix_scale=self.fix_scale)
        if int(ref.n_inliers) < 20:
            self.stats["refine_fail"] += 1
            self._sim3_cooldown[cand_id] = kf.kf_id + self.sim3_cooldown_kfs
            return None
        # s12 maps candidate-camera coords to current-camera coords: the
        # corrected current pose is S_cw = S12 T_candidate_cw
        return cand_id, ref.s12.cpu().numpy() @ _sim3_of(ckf)

    def _search_by_sim3(self, m, kf, ckf, s12, my, their, my_feat, their_feat):
        """ops/sim3solver.search_by_sim3 over the two keyframes' point-carrying
        rows -> the new mutually agreed pairs (feature indices into kf, ckf)
        beyond the matched ones; `m` is the live Map or a _MapView."""
        cam = self.camera

        def pack(akf, rows, matched_rows):
            pids = akf.map_pt[rows]
            p = np.maximum(pids, 0)
            valid = m.pt_valid[p] & (pids >= 0)
            pts_c = m.pt_xyz[p] @ akf.t_cw[:3, :3].T + akf.t_cw[:3, 3]
            return (self._tensor(pts_c, np.float32), self._tensor(m.pt_desc[p].view(np.int32)),
                    self._tensor(m.pt_dmax[p], np.float32), self._tensor(akf.uv_und[rows], np.float32),
                    self._tensor(akf.desc[rows].view(np.int32)), self._tensor(akf.level[rows], np.int32),
                    self._tensor(valid), self._tensor(np.isin(rows, matched_rows)))

        match1, agree = sim3solver.search_by_sim3(
            self._tensor(s12, np.float32), *pack(kf, my, my_feat), *pack(ckf, their, their_feat),
            self._tensor(cam.K, np.float32), float(cam.width), float(cam.height),
            math.log(kf.scale_factor), kf.n_levels)
        rows = np.nonzero(agree.cpu().numpy())[0]
        return my[rows], their[match1.cpu().numpy()[rows]]

    def _guided_matches(self, kf, s_cw: np.ndarray, pids: np.ndarray, radius: float = 10.0):
        """Points `pids` projected through the Sim3 s_cw (de-scaled to SE3, as
        the reference does, :445-449) into kf and Hamming-matched
        (SearchByProjection with Sim3, src/ORBmatcher.cc:398; th 10 in
        CorrectLoop's guided search). Returns per feature (matched pid or -1,
        distance)."""
        cam = self.camera
        if len(pids) == 0:
            return np.full(len(kf.map_pt), -1, np.int64), np.zeros(len(kf.map_pt), np.float32)
        best_pt, best_d, ok, _ = project_and_match(
            *self.map.pack_points(pids, len(pids), device=self.device),
            self._tensor(_sim3_to_se3(s_cw)), self._tensor(kf.uv_und, np.float32),
            self._tensor(kf.desc.view(np.int32)), self._tensor(kf.level, np.int32), self._tensor(kf.valid),
            cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height),
            float(radius), float(matching.TH_LOW), math.log(kf.scale_factor), kf.n_levels)
        best_pt, ok = best_pt.cpu().numpy(), ok.cpu().numpy()
        return np.where(ok, pids[np.minimum(best_pt, len(pids) - 1)], -1), best_d.cpu().numpy()

    # -- correction ----------------------------------------------------------

    def _fuse_into(self, target, matched):
        """Loop points into `target` (the loop point wins a conflict,
        reference :672): feature -> matched pid (or -1)."""
        m = self.map
        for feat_idx in np.nonzero(matched >= 0)[0]:
            lp = m.resolve_replaced(int(matched[feat_idx]))
            if lp < 0:
                continue  # absorbed by an earlier replace in this pass
            old = int(target.map_pt[feat_idx])
            if old >= 0 and m.pt_valid[old] and old != lp:
                m.replace_point(old, lp)
            elif old < 0 and target.kf_id not in m.obs.get(lp, {}):
                m.add_observation(lp, target.kf_id, int(feat_idx))

    def _correct_loop(self, kf: KeyFrame, loop_kf_id: int, s_cur_corr: np.ndarray, loop_pids):
        m = self.map
        t0 = time.perf_counter()
        # a newer loop stops a running global BA (reference :460-473)
        if self.gba is not None:
            self.gba.abort()

        # 1. corrected Sim3 of the current keyframe's covisible group (:497-571)
        s_cur_inv = np.linalg.inv(_sim3_of(kf))
        corrected: dict[int, np.ndarray] = {}
        non_corrected: dict[int, np.ndarray] = {}
        for gid in [kf.kf_id] + kf.best_covisible():
            gkf = m.keyframes.get(gid)
            if gkf is None or gkf.bad:
                continue
            s_old = _sim3_of(gkf)
            corrected[gid] = s_old @ s_cur_inv @ s_cur_corr
            non_corrected[gid] = s_old

        # 2. the group's points remapped (p' = S_corrected^-1 S_old p), one
        # batched transform per member, then the members' poses; each moved
        # point remembers the member that moved it (mnCorrectedReference)
        corrected_by = np.full(m.n_points, -1, np.int64)
        for gid, s_corr in corrected.items():
            gkf = m.keyframes[gid]
            corr_tf = np.linalg.inv(s_corr) @ non_corrected[gid]
            pids_g = np.unique(gkf.map_pt[gkf.map_pt >= 0])
            pids_g = pids_g[m.pt_valid[pids_g] & (corrected_by[pids_g] < 0)]
            if len(pids_g):
                corrected_by[pids_g] = gid
                m.pt_xyz[pids_g] = (m.pt_xyz[pids_g] @ corr_tf[:3, :3].T + corr_tf[:3, 3]).astype(np.float32)
            gkf.set_pose(_sim3_to_se3(s_corr))
            m.update_connections(gkf)
        m.pt_version += 1  # direct pt_xyz writes

        # 3. the loop points fused into the current keyframe, then
        # SearchAndFuse over the whole corrected group at radius 4 (:646-676)
        self._fuse_into(kf, self._guided_matches(kf, s_cur_corr, loop_pids)[0])
        prev_neighbors = {gid: set(m.keyframes[gid].covis) for gid in corrected if gid in m.keyframes}
        for gid in corrected:
            gkf = m.keyframes.get(gid)
            if gkf is None or gkf.bad or gid == kf.kf_id:
                continue
            # the corrected pose is already written back: as a Sim3 it has
            # scale 1 and feeds the guided matcher directly
            self._fuse_into(gkf, self._guided_matches(gkf, gkf.t_cw, loop_pids[m.pt_valid[loop_pids]],
                                                      radius=4.0)[0])

        # 3c. LoopConnections (:595-623): covisibility links created by the
        # fusion, minus the pre-loop and intra-group links
        loop_connections: dict[int, set] = {}
        for gid in corrected:
            gkf = m.keyframes.get(gid)
            if gkf is None or gkf.bad:
                continue
            m.update_connections(gkf)
            new_links = set(gkf.covis) - prev_neighbors.get(gid, set()) - set(corrected)
            if new_links:
                loop_connections[gid] = new_links
        t0 = self._lap("correction", t0)

        # 4. the essential graph (reference :621 / Optimizer.cc:873)
        self._optimize_essential_graph(kf, loop_kf_id, corrected, non_corrected, loop_connections, corrected_by)
        t0 = self._lap("essential_graph", t0)
        # loop-edge endpoints are never culled (KeyFrame::AddLoopEdge sets mbNotErase)
        kf.loop_edges.add(loop_kf_id)
        kf.not_erase = True
        m.keyframes[loop_kf_id].loop_edges.add(kf.kf_id)
        m.keyframes[loop_kf_id].not_erase = True

        # 5. global BA on the transient worker (:634)
        self.gba.launch(kf.kf_id)
        self._lap("gba_launch", t0)
        self.last_loop_kf_id = kf.kf_id
        self.n_loops_closed += 1
        m.big_change_idx += 1
        self.closure_splits.append(dict(self.last_split, kf_id=kf.kf_id, loop_kf_id=loop_kf_id))

    def _optimize_essential_graph(self, kf, loop_kf_id, corrected, non_corrected, loop_connections, corrected_by):
        m = self.map
        kfs = sorted(k.kf_id for k in m.good_keyframes())
        slot = {kf_id: i for i, kf_id in enumerate(kfs)}
        k = len(kfs)
        poses = np.stack([corrected[i] if i in corrected else _sim3_of(m.keyframes[i]) for i in kfs])
        fixed = np.zeros(k, bool)
        fixed[slot[loop_kf_id]] = True

        edge_i, edge_j, meas = [], [], []
        seen = set()

        def add_edge(a, b, s_a=None, s_b=None):
            if a not in slot or b not in slot or (min(a, b), max(a, b)) in seen:
                return
            seen.add((min(a, b), max(a, b)))
            sa = _sim3_of(m.keyframes[a]) if s_a is None else s_a
            sb = _sim3_of(m.keyframes[b]) if s_b is None else s_b
            edge_i.append(slot[a])
            edge_j.append(slot[b])
            meas.append((sb @ np.linalg.inv(sa)).astype(np.float32))

        # LoopConnections first (Optimizer.cc:920-960), measured with the
        # corrected poses
        for a, links in loop_connections.items():
            for b in links:
                add_edge(a, b)
        for kf_id in kfs:
            gkf = m.keyframes[kf_id]
            # spanning tree, measured with the pre-correction poses
            if gkf.parent is not None:
                pa = m.keyframes.get(gkf.parent)
                if pa is not None and not pa.bad:
                    add_edge(kf_id, gkf.parent, non_corrected.get(kf_id, _sim3_of(gkf)),
                             non_corrected.get(gkf.parent, _sim3_of(pa)))
            for le in gkf.loop_edges:
                add_edge(kf_id, le)
            # strong covisibility (weight >= 100, reference minFeat :908)
            for nb, w in gkf.covis.items():
                nkf = m.keyframes.get(nb)
                if w >= 100 and nb in slot and nkf is not None:
                    add_edge(kf_id, nb, non_corrected.get(kf_id, _sim3_of(gkf)),
                             non_corrected.get(nb, _sim3_of(nkf)))
        # the new loop constraint: current <-> loop keyframe, corrected relative
        a, b = kf.kf_id, loop_kf_id
        if (min(a, b), max(a, b)) not in seen:
            edge_i.append(slot[a])
            edge_j.append(slot[b])
            meas.append((_sim3_of(m.keyframes[b]) @ np.linalg.inv(corrected[a])).astype(np.float32))
        if not edge_i:
            return

        if self.mesh is not None and k >= self.dist_min_vertices:
            res = solve_pose_graph_dist(poses.astype(np.float32), fixed, np.asarray(edge_i), np.asarray(edge_j),
                                        np.stack(meas), np.ones(len(edge_i), bool), self.mesh, n_iters=20)
            self.stats["posegraph_distributed"] += 1
        else:
            res = posegraph.solve_pose_graph(
                self._tensor(poses, np.float32), self._tensor(fixed), self._tensor(edge_i, np.int64),
                self._tensor(edge_j, np.int64), self._tensor(np.stack(meas)),
                torch.ones(len(edge_i), dtype=torch.bool, device=self.device), n_iters=20)
        out = res.poses.cpu().numpy()
        self.last_split.update(eg_vertices=k, eg_edges=len(edge_i), eg_iterations=res.iterations)

        # write-back: each point through its reference keyframe's transform
        # from the vertex's initial Sim3 (the corrected one for the group) to
        # the optimized one (one batched gather), then the poses; a point the
        # correction moved follows the keyframe that moved it (reference
        # OptimizeEssentialGraph: vScw, mnCorrectedReference). The JAX package
        # maps from the pre-correction pose, which corrects those points twice
        # (ROADMAP.md Queue 3).
        pids = m.all_point_ids()
        kfs_arr = np.asarray(kfs, np.int64)
        ref = np.where(corrected_by[pids] >= 0, corrected_by[pids], m.pt_ref_kf[pids])
        pos = np.minimum(np.searchsorted(kfs_arr, ref), k - 1)
        in_slot = kfs_arr[pos] == ref
        # a point whose reference keyframe is no vertex takes its first observer
        for i in np.nonzero(~in_slot)[0]:
            o = m.obs.get(int(pids[i]))
            first = next(iter(o), None) if o else None
            if first in slot:
                pos[i] = slot[first]
                in_slot[i] = True
        tf_all = np.linalg.inv(out).astype(np.float32) @ poses
        sel = np.nonzero(in_slot)[0]
        if len(sel):
            tfs = tf_all[pos[sel]]
            p = m.pt_xyz[pids[sel]]
            m.pt_xyz[pids[sel]] = (np.einsum("nij,nj->ni", tfs[:, :3, :3], p) + tfs[:, :3, 3]).astype(np.float32)
        for kf_id, s in slot.items():
            m.keyframes[kf_id].set_pose(_sim3_to_se3(out[s]))
        m.pt_version += 1  # direct pt_xyz writes
        m.update_points_batch(pids)
