"""The port's landmark-sharded BA (parallel/dist_ba), its shard mesh and its
process groups against the JAX package's parallel/dist_ba and multihost.

JAX runs on its 8-virtual-device CPU mesh (tests/conftest.py), the port on
`make_mesh(n, device="cpu")`; both take the same problem, built from a numpy
seed by tests/test_optim.make_ba_problem. The partitioner is bit-equal.
The solvers are the same math with float32 sums grouped per shard, so they
agree within stated tolerances: poses within 1e-3, points within 2e-3 and
costs within 1e-4 relative of the JAX package's at the same shard count;
every mesh size within the JAX tests' 5e-3 pose error of the single-device
ops/optim.bundle_adjustment. Two processes of 4 shards each over gloo (a
file store under tmp_path) match one process of 8: poses within 1e-4,
points within 2e-3, the cost within 1e-5 relative.
"""

import time

import numpy as np
import pytest
import torch
from test_optim import BF, CX, CY, FX, FY, make_ba_problem, pose_err

from orbslam2commentedbyxcm_tpu.parallel import dist_ba as jdist_ba
from orbslam2commentedbyxcm_tpu.utils import geometry as jgeo
from orbslam2commentedbyxcm_tpu_torch.ops import optim as toptim
from orbslam2commentedbyxcm_tpu_torch.parallel import dist_ba, multihost
from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import ShardMesh, make_mesh

torch.set_num_threads(1)

CAM = (FX, FY, CX, CY, BF)
SOLVERS = {"dense": ({}, {}), "cg": ({"n_cg": 40}, {"n_cg": 40})}


def _problem(seed=0, n_poses=5, n_pts=96, stereo=False, drop=0.0):
    """Poses and points perturbed off the truth, the first pose fixed, a
    share `drop` of the edges masked out."""
    rng = np.random.default_rng(seed)
    poses, pts, op, opt_, ouv = make_ba_problem(rng, n_poses=n_poses, n_pts=n_pts, stereo=stereo)
    poses_0 = poses.copy()
    for i in range(1, len(poses)):
        poses_0[i] = np.asarray(jgeo.se3_exp(rng.normal(0, 0.02, 6).astype(np.float32))) @ poses[i]
    pts_0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed = np.zeros(len(poses), bool)
    fixed[0] = True
    mask = np.ones(len(op), bool)
    mask[rng.choice(len(op), size=int(drop * len(op)), replace=False)] = False
    return dict(truth=(poses, pts), poses=poses_0.astype(np.float32), fixed=fixed, points=pts_0,
                edges=(op, opt_, ouv, mask, np.ones(len(op), np.float32)))


def _shards(pr, n):
    return dist_ba.shard_ba_problem(pr["points"], np.ones(len(pr["points"]), bool), *pr["edges"], n)


def _port_solve(pr, mesh, solver, n_iters=12, **kw):
    sh = _shards(pr, mesh.n_shards)
    fn = dist_ba.distributed_bundle_adjustment_cg if solver == "cg" else dist_ba.distributed_bundle_adjustment
    poses, pts, err = fn(mesh, torch.from_numpy(pr["poses"]).to(mesh.device),
                         torch.from_numpy(pr["fixed"]).to(mesh.device),
                         *[mesh.local(a) for a in (sh[0], sh[1], *sh[3:])], *CAM, n_iters=n_iters, **kw)
    pts = mesh.gather(pts).cpu().numpy()
    flat = np.zeros_like(pr["points"])
    flat[sh[2][sh[1]]] = pts[sh[1]]
    return poses.cpu().numpy(), flat, float(err)


def _jax_solve(pr, n, solver, n_iters=12, **kw):
    import jax.numpy as jnp

    sh = jdist_ba.shard_ba_problem(pr["points"], np.ones(len(pr["points"]), bool), *pr["edges"], n)
    fn = jdist_ba.distributed_bundle_adjustment_cg if solver == "cg" else jdist_ba.distributed_bundle_adjustment
    poses, pts, err = fn(jdist_ba.make_mesh(n), jnp.asarray(pr["poses"]), jnp.asarray(pr["fixed"]),
                         *[jnp.asarray(a) for a in (sh[0], sh[1], *sh[3:])], *CAM, n_iters=n_iters, **kw)
    flat = np.zeros_like(pr["points"])
    flat[sh[2][sh[1]]] = np.asarray(pts)[sh[1]]
    return np.asarray(poses), flat, float(err)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_shard_ba_problem_bit_equal(n):
    pr = _problem(seed=1, n_pts=61, stereo=True, drop=0.1)  # 61 points: ragged shards
    args = (pr["points"], np.arange(61) % 5 != 0, *pr["edges"], n)
    for a, b in zip(dist_ba.shard_ba_problem(*args), jdist_ba.shard_ba_problem(*args)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_dist_ba_matches_jax(n, solver):
    pr = _problem()
    poses, pts, err = _port_solve(pr, make_mesh(n, device="cpu"), solver, **SOLVERS[solver][0])
    j_poses, j_pts, j_err = _jax_solve(pr, n, solver, **SOLVERS[solver][1])
    np.testing.assert_allclose(poses, j_poses, atol=1e-3)
    np.testing.assert_allclose(pts, j_pts, atol=2e-3)
    assert abs(err - j_err) <= 1e-4 * j_err
    # the single-device solve's optimum, and the truth up to the gauge
    ref = toptim.bundle_adjustment(
        *[torch.from_numpy(a) for a in (pr["poses"], pr["fixed"], pr["points"], np.ones(len(pr["points"]), bool),
                                        *pr["edges"][:2])],
        *[torch.from_numpy(a) for a in pr["edges"][2:]], *CAM, schedule=((12, True),), relabel_between=False)
    for i in range(len(poses)):
        assert pose_err(poses[i], ref.poses[i].numpy()) < 5e-3, i
    truth = pr["truth"][0]
    for i in range(1, len(poses)):
        assert pose_err(poses[i] @ np.linalg.inv(poses[i - 1]), truth[i] @ np.linalg.inv(truth[i - 1])) < 0.02
    assert np.median(np.linalg.norm(pts - pr["truth"][1], axis=-1)) < 0.08


def test_cg_with_stereo_and_invalid_edges():
    """Mixed mono / stereo edges, 10% masked, starting at the true poses:
    the fixed pose unchanged to 1e-6, the free ones near the truth and the
    JAX package's."""
    rng = np.random.default_rng(0)  # tests/test_dist_ba.py's construction
    poses, pts, op, opt_, ouv = make_ba_problem(rng, n_poses=4, n_pts=64, stereo=True)
    mask = np.ones(len(op), bool)
    mask[rng.choice(len(op), size=len(op) // 10, replace=False)] = False
    fixed = np.zeros(len(poses), bool)
    fixed[0] = True
    pr = dict(truth=(poses, pts), poses=poses.astype(np.float32), fixed=fixed,
              points=pts + rng.normal(0, 0.03, pts.shape).astype(np.float32),
              edges=(op, opt_, ouv, mask, np.ones(len(op), np.float32)))
    poses, pts, err = _port_solve(pr, make_mesh(4, device="cpu"), "cg", n_iters=8, n_cg=30)
    j_poses, j_pts, j_err = _jax_solve(pr, 4, "cg", n_iters=8, n_cg=30)
    assert np.isfinite(err)
    np.testing.assert_allclose(poses[0], pr["poses"][0], atol=1e-6)
    for i in range(1, len(poses)):
        assert pose_err(poses[i], pr["truth"][0][i]) < 0.02
    np.testing.assert_allclose(poses, j_poses, atol=1e-3)
    np.testing.assert_allclose(pts, j_pts, atol=2e-3)
    assert abs(err - j_err) <= 1e-4 * j_err


def test_mesh_psum_and_local():
    """psum sums the leading shard axis of each tensor (several in one
    reduction), counts the reductions and their bytes; `local` checks the
    leading axis."""
    mesh = make_mesh(3, device="cpu")
    a = torch.arange(12.0).reshape(3, 4)
    b = torch.ones(3, 2, 2)
    sa, sb = mesh.psum(a, b)
    torch.testing.assert_close(sa, a.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(sb, torch.full((2, 2), 3.0), rtol=0, atol=0)
    assert (mesh.n_psum, mesh.psum_bytes) == (1, 4 * 4 + 4 * 4)
    assert mesh.axis_names == ("ici",) and mesh.n_shards == 3 and mesh.gather(a) is a
    assert torch.equal(mesh.local(np.arange(6).reshape(3, 2)), torch.arange(6).reshape(3, 2))
    with pytest.raises(ValueError, match="3 shards"):
        mesh.local(np.zeros((4, 2)))
    with pytest.raises(ValueError):
        ShardMesh(0, "cpu")


def test_multihost_single_process(monkeypatch):
    """Without torchrun's variables `initialize()` returns False and the
    hybrid mesh is a flat ("ici",) one; the JAX package's launcher variables
    are not read (a stated divergence)."""
    from orbslam2commentedbyxcm_tpu.parallel import multihost as jmultihost

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert multihost.initialize() is False
    mesh = multihost.make_hybrid_mesh(4, device="cpu")
    assert mesh.axis_names == ("ici",) and mesh.n_shards == 4 and mesh.group is None
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var)
    assert jmultihost.initialize() is False  # the JAX package's, without its variables


def _posegraph_problem():
    from test_torch_dist_posegraph import _problem as pg_problem

    p0, fixed, ei, ej, meas, mask = pg_problem(k=24, e=77)
    return np.asarray(p0), fixed, ei, ej, meas, mask


def _rank_solve(init_file: str, pr: dict, pg: tuple) -> dict:
    """One rank of the two-process run: 4 local shards of the BA problem
    (CG) and of the pose graph."""
    from orbslam2commentedbyxcm_tpu_torch.parallel import system_bridge

    torch.set_num_threads(1)
    assert multihost.initialize(init_method=f"file://{init_file}")
    mesh = multihost.make_hybrid_mesh(4, device="cpu")
    poses, pts, err = _port_solve(pr, mesh, "cg", n_cg=40)
    graph = system_bridge.solve_pose_graph_dist(*pg, mesh, n_iters=25)
    return {"axes": mesh.axis_names, "shards": mesh.n_shards, "poses": poses, "points": pts, "cost": err,
            "graph": graph.poses.numpy(), "graph_cost": float(graph.cost), "psums": mesh.n_psum}


def test_two_processes_match_one(tmp_path):
    """2 processes x 4 shards over gloo (file store) against 1 x 8: BA (CG)
    poses and the pose graph within 1e-4, points within 2e-3 (the far,
    thinly observed ones); both ranks hold the same result."""
    from orbslam2commentedbyxcm_tpu_torch.parallel import system_bridge

    pr, pg = _problem(), _posegraph_problem()
    ranks = multihost.launch_local(_rank_solve, 2, args=(str(tmp_path / "store"), pr, pg), timeout_s=120)
    mesh = make_mesh(8, device="cpu")
    poses, pts, err = _port_solve(pr, mesh, "cg", n_cg=40)
    graph = system_bridge.solve_pose_graph_dist(*pg, mesh, n_iters=25)
    for r in ranks:
        assert r["axes"] == ("dcn", "ici") and r["shards"] == 8
        np.testing.assert_allclose(r["poses"], poses, atol=1e-4)
        np.testing.assert_allclose(r["points"], pts, atol=2e-3)
        assert abs(r["cost"] - err) <= 1e-5 * err
        np.testing.assert_allclose(r["graph"], graph.poses.numpy(), atol=1e-4)
    for key in ("poses", "points", "graph"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    assert ranks[0]["psums"] == ranks[1]["psums"] > 0


def _rank_fails(init_file: str) -> int:
    """Rank 1 raises before the collective rank 0 waits in."""
    assert multihost.initialize(init_method=f"file://{init_file}")
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()
    return 0


def test_launch_local_stops_on_a_failing_rank(tmp_path):
    """A rank's exception reaches the launcher at once (with its traceback),
    and the rank left waiting in a collective is stopped, not waited for."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised:(.|\n)*rank 1 fails"):
        multihost.launch_local(_rank_fails, 2, args=(str(tmp_path / "store"),), timeout_s=100)
    assert time.monotonic() - t0 < 60
