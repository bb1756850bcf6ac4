"""Relocalization: BoW candidate retrieval + batched RANSAC EPnP recovery.

Counterpart of orbslam2commentedbyxcm_tpu/models/relocalization.py
(reference Tracking::Relocalization, src/Tracking.cc:1511-1684):
DetectRelocalizationCandidates, then for each of the best 5 candidates a
SearchByBoW against its map points (>= 15 matches), EPnP RANSAC (256 lanes in
one batch), and the widen / re-optimize / narrow cascade through
`Tracking._match_and_optimize` (a pose-kernel launch each), accepted at >= 50
inliers. The frame's descriptors, the candidate's points and the RANSAC batch
stay on the frame's device; the host reads sit where the JAX package calls
np.asarray.

`last_split` holds the seconds of the last call's pieces (BoW transform,
database query, search, EPnP, pose solves), each ending at a host read.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.ops import bow, matching, pnp
from orbslam2commentedbyxcm_tpu_torch.ops.twoview import k_matrix

SPLIT_KEYS = ("bow", "query", "search", "epnp", "pose")


class Relocalizer:
    def __init__(self, world_map, camera, keyframe_db=None, vocabulary=None,
                 min_inliers: int = 50):
        self.map = world_map
        self.camera = camera
        self.db = keyframe_db
        self.voc = vocabulary
        # hard acceptance gate (reference src/Tracking.cc:1666: nGood >= 50)
        self.min_inliers = min_inliers
        # EPnP RANSAC draws (the JAX package keys jax.random with PRNGKey(7))
        self.generator = torch.Generator(device=world_map.device)
        self.generator.manual_seed(7)
        self.last_split = dict.fromkeys(SPLIT_KEYS, 0.0)

    def _point_features(self, kf, pids):
        """Slot of each point's observation in `kf` (-1 when it has none)."""
        return np.array([self.map.obs[int(p)].get(kf.kf_id, -1) for p in pids], np.int64)

    def relocalize(self, frame, tracking) -> bool:
        """Try to place `frame` in the map; True with its pose and map links
        set."""
        split = self.last_split = dict.fromkeys(SPLIT_KEYS, 0.0)
        if self.db is None or self.voc is None:
            return False
        t0 = time.perf_counter()
        fdev = frame.device_arrays()
        dev = fdev["desc"].device
        words, groups, weights = bow.transform(self.voc, fdev["desc"], frame.valid)
        ids, vals = bow.bow_vector(words, weights, self.voc.n_words)
        t1 = time.perf_counter()
        split["bow"] += t1 - t0
        candidates = self.db.detect_relocalization_candidates(ids, vals, self.map)
        split["query"] += time.perf_counter() - t1
        if not candidates:
            return False

        cam = self.camera
        k_mat = k_matrix(cam, dev)
        groups_dev = torch.from_numpy(groups).to(dev)
        uv = fdev["uv_und"]
        sigma2 = torch.from_numpy(frame.sigma2().astype(np.float32)).to(dev)
        for kf_id in candidates[:5]:
            kf = self.map.keyframes.get(kf_id)
            if kf is None or kf.bad:
                continue
            t0 = time.perf_counter()
            pids = np.unique(kf.map_pt[kf.map_pt >= 0])
            pids = pids[self.map.pt_valid[pids]]
            if len(pids) < 15:
                continue
            pt_desc = torch.from_numpy(self.map.pt_desc[pids].view(np.int32)).to(dev)
            all_pts = torch.ones(len(pids), dtype=torch.bool, device=dev)
            sel = self._point_features(kf, pids)
            if kf.bow_feat_nodes is not None:
                # each point's grouping node is that of its observing feature
                pt_grp = np.where(sel >= 0, kf.bow_feat_nodes[np.maximum(sel, 0)], -1).astype(np.int32)
                idx, _, ok = matching.search_by_bow(
                    fdev["desc"], groups_dev, fdev["valid"],
                    pt_desc, torch.from_numpy(pt_grp).to(dev), all_pts, mutual=False)
            else:
                idx, _, ok = matching.match_nn(
                    matching.hamming_matrix(fdev["desc"], pt_desc), fdev["valid"], all_pts, None,
                    max_dist=matching.TH_LOW, ratio=0.75)
            ok_np = ok.cpu().numpy()
            t1 = time.perf_counter()
            split["search"] += t1 - t0
            if ok_np.sum() < 15:
                continue
            idx_np = idx.cpu().numpy().astype(np.int64)
            pts3d = np.zeros((frame.capacity, 3), np.float32)
            pts3d[ok_np] = self.map.pt_xyz[pids[idx_np[ok_np]]]
            res = pnp.ransac_epnp(self.generator, torch.from_numpy(pts3d).to(dev), uv, ok, k_mat, sigma2)
            success = bool(res.success)
            t2 = time.perf_counter()
            split["epnp"] += t2 - t1
            if not success:
                continue
            frame.set_pose(res.t_cw.cpu().numpy())
            frame.map_pt = np.where(ok_np & res.inliers.cpu().numpy(), pids[idx_np], -1)
            # per-point source angle (observing feature in the candidate) for
            # the orientation histogram of the widened projection search
            pt_angle = np.where(sel >= 0, kf.angle[np.maximum(sel, 0)], 0.0).astype(np.float32)

            # widen -> re-optimize -> narrow cascade with the hard >= 50 gate
            # (reference src/Tracking.cc:1628-1666)
            n = tracking._match_and_optimize(frame, pids, frame.t_cw, radius=10.0, keep_existing=True,
                                             pt_angle=pt_angle)
            if self.min_inliers * 0.6 <= n < self.min_inliers:
                # narrower window, stricter Hamming (th = 3, ORBdist = 64)
                n = tracking._match_and_optimize(frame, pids, frame.t_cw, radius=3.0, max_dist=64.0,
                                                 keep_existing=True, pt_angle=pt_angle)
            split["pose"] += time.perf_counter() - t2
            if n >= self.min_inliers:
                tracking.ref_kf_id = kf_id
                tracking.velocity = None
                return True
        return False
