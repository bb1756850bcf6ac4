"""Transient global bundle adjustment on a worker thread.

Counterpart of orbslam2commentedbyxcm_tpu/models/gba.py, the reference's GBA
thread (src/LoopClosing.cc):

  * CorrectLoop starts a transient thread running RunGlobalBundleAdjustment
    (:634); a newer accepted loop stops a running one (mbStopGBA,
    mnFullBAIdx, :460-473);
  * the results are staged and applied under the map lock once the solve
    ends, the correction reaching keyframes created meanwhile through the
    spanning tree and their points through their reference keyframe
    (:709-815).

The solve is ops/optim.bundle_adjustment over every good keyframe (the
origin fixed), 10 plain iterations in chunks of 3 with the stop event polled
between chunks. With a shard mesh (`mesh=`, parallel/mesh.ShardMesh on the
same device) a problem of at least `dist_min_points` points is solved by
the landmark-sharded Schur-CG of parallel/dist_ba instead
(parallel/system_bridge), counted in `n_distributed`. The snapshot is taken
by the caller under the map lock; the solve holds no lock; write-back takes
the lock with a timeout, so a stop raised while it waits cannot deadlock
against the thread that raised it.

The solve runs on the System's device from its own thread. On CUDA both
threads use the default stream, so the card runs their kernels in issue
order. An exception inside the thread is kept and raised again by `wait()`
(and so by System.shutdown / save_map / localization mode): a global BA that
dies is an error, never a silent skip.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.models.local_mapping import assemble_ba_problem, solve_ba_problem
from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import same_device
from orbslam2commentedbyxcm_tpu_torch.parallel.system_bridge import solve_ba_problem_dist


class GlobalBA:
    def __init__(self, world_map, camera, map_lock, n_iters: int = 10, chunk: int = 3, device=None, mesh=None,
                 dist_min_points: int = 2048):
        self.map = world_map
        self.camera = camera
        self.lock = map_lock
        self.n_iters = n_iters
        self.chunk = chunk
        self.device = world_map.device if device is None else torch.device(device)
        if mesh is not None and not same_device(mesh.device, self.device):
            raise ValueError(f"the mesh is on {mesh.device}, global BA on {self.device}")
        self.mesh = mesh
        self.dist_min_points = dist_min_points
        self.n_distributed = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()   # the current run's stop flag
        self._ctl = threading.Lock()     # serializes abort() / launch()
        self._error: Exception | None = None
        # == reference mnFullBAIdx: a result is discarded when a newer loop
        # bumped the index while its solve ran
        self.full_ba_idx = 0
        self.n_completed = 0
        self.n_aborted = 0
        # the last finished solve: seconds, poses, points, chunks run
        self.last_stats: dict = {}

    # -- control (callers may hold the map lock) ---------------------------

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def abort(self):
        """Stop a running solve and leave it (CorrectLoop :460-473, no join):
        callers often hold the map lock. The abandoned thread sees its own
        stop event, skips the write-back and exits; each launch gets a fresh
        event, so a relaunch cannot un-stop it."""
        with self._ctl:
            t = self._thread
            if t is None or not t.is_alive():
                return
            self._stop.set()
            self.full_ba_idx += 1
            self._thread = None
            self.n_aborted += 1

    def launch(self, loop_kf_id: int):
        """Snapshot the map (the caller holds the map lock) and start the
        solve thread (reference :630-634)."""
        self._raise_error()
        self.abort()
        m = self.map
        kf_ids = [k.kf_id for k in m.good_keyframes()]
        if len(kf_ids) < 3:
            return
        problem = assemble_ba_problem(m, kf_ids, fixed_ids={m.origin_kf_id})
        if problem is None:
            return
        with self._ctl:
            stop = threading.Event()
            self._stop = stop
            t = threading.Thread(target=self._run, args=(problem, self.full_ba_idx, m, stop),
                                 daemon=True, name="global-ba")
            self._thread = t
            t.start()

    def wait(self):
        """Block until the current (not aborted) solve has finished and
        written back; raise what any solve thread raised. Do not call while
        holding the map lock."""
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()
        self._raise_error()

    def _raise_error(self):
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("global BA failed on its worker thread") from err

    # -- worker --------------------------------------------------------------

    def _run(self, problem, idx: int, m, stop: threading.Event):
        try:
            self._solve_and_write(problem, idx, m, stop)
        except Exception as exc:  # kept, traceback and all, for wait() to raise
            self._error = exc

    def _solve_and_write(self, problem, idx, m, stop):
        # GlobalBundleAdjustemnt(map, 10, &mbStopGBA, nLoopKF, false): plain
        # (no Huber, no relabel) iterations in chunks
        chunks = tuple((min(self.chunk, self.n_iters - s), False) for s in range(0, self.n_iters, self.chunk))
        t0 = time.perf_counter()
        distributed = self.mesh is not None and len(problem["pids"]) >= self.dist_min_points
        if distributed:
            res = solve_ba_problem_dist(problem, self.camera, self.mesh, n_iters=self.n_iters, chunk=self.chunk,
                                        abort_check=stop.is_set)
            out_poses, out_points = res.poses, res.points
            self.n_distributed += 1
        else:
            res = solve_ba_problem(problem, self.camera, self.device, chunks, abort_check=stop.is_set,
                                   relabel_between=False)
            out_poses, out_points = res.poses.cpu().numpy(), res.points.cpu().numpy()
        stats = {"seconds": time.perf_counter() - t0, "poses": len(problem["kf_slot"]),
                 "points": len(problem["pids"]), "chunks": len(chunks), "distributed": distributed}
        if stop.is_set() or idx != self.full_ba_idx:
            return
        # write-back under the map lock (reference :732-809)
        while not stop.is_set():
            if self.lock.acquire(timeout=0.01):
                try:
                    if idx == self.full_ba_idx and m is self.map:
                        self._propagate(problem, out_poses, out_points, m)
                        self.n_completed += 1
                        self.last_stats = stats
                finally:
                    self.lock.release()
                return

    def _propagate(self, problem, out_poses, out_points, m):
        """Apply staged results: solved keyframes take their optimized pose;
        keyframes created during the solve inherit the correction through
        the spanning tree (T_child_gba = T_child_cur T_parent_cur^-1
        T_parent_gba); points likewise through their reference keyframe
        (reference RunGlobalBundleAdjustment, :745-805)."""
        t_gba = {kf_id: out_poses[s] for kf_id, s in problem["kf_slot"].items() if kf_id in m.keyframes}

        # spanning-tree walk from the origin; solved poses seed it
        t_before: dict[int, np.ndarray] = {}
        children_of: dict[int, list[int]] = {}
        for kf in m.keyframes.values():
            if kf.parent is not None:
                children_of.setdefault(kf.parent, []).append(kf.kf_id)
        frontier, visited = [m.origin_kf_id], set()
        while frontier:
            kf_id = frontier.pop()
            if kf_id in visited or kf_id not in m.keyframes:
                continue
            visited.add(kf_id)
            kf = m.keyframes[kf_id]
            if kf_id not in t_gba:
                pa = kf.parent
                if pa is None or pa not in t_before:
                    continue  # disconnected from the solved set: left as is
                t_gba[kf_id] = (kf.t_cw @ np.linalg.inv(t_before[pa]) @ t_gba[pa]).astype(np.float32)
            t_before[kf_id] = kf.t_cw.copy()
            kf.set_pose(t_gba[kf_id])
            frontier.extend(children_of.get(kf_id, ()))

        # points: solved ones directly (if still alive), the others through
        # the before/after transform of their reference keyframe
        alive = m.all_point_ids()
        solved = np.asarray(problem["pids"], np.int64)
        live = m.pt_valid[solved]
        m.pt_xyz[solved[live]] = out_points[live]
        is_solved = np.zeros(m.n_points, bool)
        is_solved[solved] = True
        rest = alive[~is_solved[alive]]
        if len(rest):
            refs = m.pt_ref_kf[rest]
            for ref_id in np.unique(refs):
                tb = t_before.get(int(ref_id))
                kf = m.keyframes.get(int(ref_id))
                if tb is None or kf is None:
                    continue
                tf = np.linalg.inv(kf.t_cw) @ tb  # world -> old camera -> new world
                sel = rest[refs == ref_id]
                m.pt_xyz[sel] = (m.pt_xyz[sel] @ tf[:3, :3].T + tf[:3, 3]).astype(np.float32)
        m.pt_version += 1  # direct pt_xyz writes
        m.big_change_idx += 1
