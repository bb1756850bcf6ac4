"""Edge-sharded distributed Sim3 pose-graph optimization (the essential
graph over a shard mesh).

Counterpart of orbslam2commentedbyxcm_tpu/parallel/dist_posegraph.py: the
edges are dealt to the shards in contiguous blocks, the poses are
replicated, and the solve is the matrix-free block-Jacobi PCG LM of
ops/posegraph.optimize_pose_graph_cg with its edge-wise sums reduced by
`mesh.psum` (one (K, 7) reduction per CG iteration); nothing of size O(K^2)
exists. The same function runs single-device and sharded, so the two differ
only in how the sums are grouped.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu_torch.ops.posegraph import PoseGraphResult, optimize_pose_graph_cg


def shard_posegraph_problem(edge_i, edge_j, edge_meas, edge_mask, mesh):
    """Pad the edge arrays to a multiple of the mesh's shard count (padding
    edges are masked out and measure the identity) and split them into
    (n_shards, Es) blocks of consecutive edges; numpy."""
    n = mesh.n_shards
    e = len(edge_i)
    e_pad = -(-e // n) * n
    pad = e_pad - e

    def padded(a, fill, dtype):
        a = np.asarray(a)
        extra = np.full((pad,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, extra]).astype(dtype).reshape((n, e_pad // n) + a.shape[1:])

    meas = padded(edge_meas, 0, np.float32)
    meas.reshape(e_pad, 4, 4)[e:] = np.eye(4, dtype=np.float32)
    return (padded(edge_i, 0, np.int32), padded(edge_j, 0, np.int32), meas, padded(edge_mask, False, bool))


def distributed_pose_graph(
    poses,            # (K, 4, 4) Sim3 S_cw, replicated
    fixed,            # (K,) bool, replicated
    edge_i, edge_j, edge_meas, edge_mask,   # this process's edge shards (n_local, Es, ...)
    mesh,
    n_iters: int = 20,
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
) -> PoseGraphResult:
    """Matrix-free block-Jacobi PCG pose-graph LM over an edge-sharded mesh:
    ops/posegraph.optimize_pose_graph_cg with every edge-wise reduction a
    psum of the shards' partial sums."""
    def on_mesh(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=mesh.device)

    return optimize_pose_graph_cg(
        on_mesh(poses, torch.float32), on_mesh(fixed, torch.bool), on_mesh(edge_i), on_mesh(edge_j),
        on_mesh(edge_meas, torch.float32), on_mesh(edge_mask, torch.bool), n_iters=n_iters, cg_iters=cg_iters,
        cg_tol=cg_tol, mesh=mesh)
