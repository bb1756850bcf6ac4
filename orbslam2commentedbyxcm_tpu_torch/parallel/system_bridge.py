"""The live pipeline's bridge to the distributed solvers.

Counterpart of orbslam2commentedbyxcm_tpu/parallel/system_bridge.py. With a
mesh wired (`System(mesh=...)`):

  * models/gba.GlobalBA runs `solve_ba_problem_dist` (the landmark-sharded
    Schur-CG of parallel/dist_ba) on problems of at least `dist_min_points`
    points, in chunks so its stop event is polled between them (the
    reference's mbStopGBA);
  * models/loop_closing runs the essential graph through
    `solve_pose_graph_dist` (parallel/dist_posegraph) from
    `dist_min_vertices` keyframes on.

Both take the host-side problems the single-device paths take (the problem
dict of models/local_mapping.assemble_ba_problem, the essential graph's edge
lists) and return numpy results.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.parallel import dist_ba, dist_posegraph


# CG steps per LM iteration of global BA through the mesh, the JAX package's
# value: on a 40-50 keyframe map they stop short of the dense optimum, at a
# cost 0.02-0.9% higher (ROADMAP.md Queue 3)
GBA_CG_STEPS = 25


class DistBAResult(NamedTuple):
    poses: np.ndarray        # (K, 4, 4)
    points: np.ndarray       # (P, 3)
    obs_inliers: np.ndarray  # (E,) the distributed path does not relabel
    cost: float


def solve_ba_problem_dist(problem: dict, cam, mesh, n_iters: int = 10, chunk: int = 3,
                          abort_check=None) -> DistBAResult:
    """Solve an assembled BA problem with the landmark-sharded Schur-CG
    solver over `mesh`, plain (no Huber, no relabel), in `chunk`-iteration
    calls with `abort_check` polled between them. Each call starts LM's
    damping afresh, as the JAX package's chunked calls do."""
    sh = dist_ba.shard_ba_problem(problem["points"], problem["point_valid"], problem["op"], problem["opt"],
                                  problem["ouv"], problem["omask"], problem["osig"], mesh.n_shards)
    pts_sh, pv_sh, gidx_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh = sh
    dev = mesh.device
    poses = torch.from_numpy(problem["poses"]).to(dev)
    fixed = torch.from_numpy(problem["pose_fixed"]).to(dev)
    local = [mesh.local(a) for a in (pts_sh, pv_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh)]
    pts = local[0]
    err = None
    for start in range(0, n_iters, chunk):
        poses, pts, err = dist_ba.distributed_bundle_adjustment_cg(
            mesh, poses, fixed, pts, *local[1:], cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            n_iters=min(chunk, n_iters - start), n_cg=GBA_CG_STEPS, use_huber=False)
        if start + chunk < n_iters and abort_check is not None and abort_check():
            break

    # the point shards back to the problem's flat layout
    pts_out = mesh.gather(pts).cpu().numpy().reshape(-1, 3)
    rows = pv_sh.reshape(-1)
    points = problem["points"].copy()
    points[gidx_sh.reshape(-1)[rows]] = pts_out[rows]
    return DistBAResult(poses=poses.cpu().numpy(), points=points, obs_inliers=problem["omask"].copy(),
                        cost=float(err))


def solve_pose_graph_dist(poses, fixed, edge_i, edge_j, edge_meas, edge_mask, mesh, n_iters: int = 20):
    """The edge-sharded essential-graph solve (in place of
    ops/posegraph.solve_pose_graph when a mesh is wired); numpy inputs."""
    shards = dist_posegraph.shard_posegraph_problem(edge_i, edge_j, edge_meas, edge_mask, mesh)
    return dist_posegraph.distributed_pose_graph(poses, fixed, *(mesh.local(a) for a in shards), mesh=mesh,
                                                 n_iters=n_iters)
