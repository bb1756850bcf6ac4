"""The port's edge-sharded essential graph (parallel/dist_posegraph and its
bridge) against the JAX package's parallel/dist_posegraph, on the problem of
tests/test_dist_posegraph.py (48 Sim3 vertices, 192 edges, a numpy seed).

Padding and masking are bit-equal to `shard_posegraph_problem`. At 1, 4 and
8 shards the port reaches the JAX package's optimum, and its own
single-device `optimize_pose_graph_cg`'s, within the JAX test's 2e-3 (the
sums are grouped per shard, so the two agree only to float32 rounding);
the cost is below 1e-3. Without a mesh the solver is the single-device one
to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_dist_posegraph import _problem

from orbslam2commentedbyxcm_tpu.parallel import dist_posegraph as jdist
from orbslam2commentedbyxcm_tpu.parallel import system_bridge as jbridge
from orbslam2commentedbyxcm_tpu.parallel.dist_ba import make_mesh as jmake_mesh
from orbslam2commentedbyxcm_tpu_torch.ops import posegraph as tposegraph
from orbslam2commentedbyxcm_tpu_torch.parallel import dist_posegraph, system_bridge
from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("n", [1, 4, 8])
def test_shard_posegraph_problem_bit_equal(n):
    _, _, ei, ej, meas, mask = _problem(k=32, e=131)  # 131 % 4, % 8 != 0: padded
    mask = mask.copy()
    mask[::7] = False
    ours = dist_posegraph.shard_posegraph_problem(ei, ej, meas, mask, make_mesh(n, device="cpu"))
    theirs = jdist.shard_posegraph_problem(ei, ej, meas, mask, jmake_mesh(n))
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.shape[0] == n and a.dtype == b.dtype
        np.testing.assert_array_equal(a.reshape(b.shape), b)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_sharded_matches_jax_and_single_device(n):
    p0, fixed, ei, ej, meas, mask = _problem()
    mesh = make_mesh(n, device="cpu")
    shards = dist_posegraph.shard_posegraph_problem(ei, ej, meas, mask, mesh)
    ours = dist_posegraph.distributed_pose_graph(np.asarray(p0), fixed, *(mesh.local(a) for a in shards), mesh=mesh,
                                                 n_iters=25)
    jmesh = jmake_mesh(n)
    theirs = jdist.distributed_pose_graph(p0, jnp.asarray(fixed), *jdist.shard_posegraph_problem(
        ei, ej, meas, mask, jmesh), mesh=jmesh, n_iters=25)
    single = tposegraph.optimize_pose_graph_cg(*_torch(p0, fixed, ei, ej, meas, mask), n_iters=25)
    assert float(ours.cost) < 1e-3 and ours.iterations >= 1
    np.testing.assert_allclose(ours.poses.numpy(), np.asarray(theirs.poses), atol=2e-3)
    np.testing.assert_allclose(ours.poses.numpy(), single.poses.numpy(), atol=2e-3)
    assert mesh.n_psum > 0


def test_one_shard_is_the_single_device_solve():
    """A 1-shard mesh sums each shard's partials over one shard: the
    sharded solve is the single-device one to the bit."""
    p0, fixed, ei, ej, meas, mask = _problem(k=32, e=128)
    mesh = make_mesh(1, device="cpu")
    ours = dist_posegraph.distributed_pose_graph(
        np.asarray(p0), fixed, *(mesh.local(a) for a in dist_posegraph.shard_posegraph_problem(
            ei, ej, meas, mask, mesh)), mesh=mesh, n_iters=25)
    single = tposegraph.optimize_pose_graph_cg(*_torch(p0, fixed, ei, ej, meas, mask), n_iters=25)
    assert torch.equal(ours.poses, single.poses) and ours.iterations == single.iterations


def test_bridge_matches_jax_bridge():
    """system_bridge.solve_pose_graph_dist with a padded edge count on 4
    shards against the JAX package's bridge: the same optimum."""
    p0, fixed, ei, ej, meas, mask = _problem(k=32, e=131)
    ours = system_bridge.solve_pose_graph_dist(np.asarray(p0), fixed, ei, ej, meas, mask,
                                               make_mesh(4, device="cpu"), n_iters=25)
    theirs = jbridge.solve_pose_graph_dist(np.asarray(p0), fixed, ei, ej, meas, mask, jmake_mesh(4), n_iters=25)
    assert float(ours.cost) < 1e-3
    np.testing.assert_allclose(ours.poses.numpy(), np.asarray(theirs.poses), atol=2e-3)
