"""The live pipeline over a shard mesh: GlobalBA(mesh=) and
LoopClosing(mesh=) against the JAX package's on one shared map, and the
whole System over a mesh.

The shared map is tests/test_torch_loop_closing.py's: the JAX System's
320x240 orbit up to the keyframe that closes its loop, copied into a port
Map, with the JAX closer's state and RANSAC draws. The port's closer runs
with a 4-shard CPU mesh and both gates at 0 (as tests/test_dist_system.py
forces the JAX package's): the loop closes as without the mesh, the
essential graph and global BA go through the mesh, and the sharded
essential graph equals the JAX package's sharded solve of the same graph
within the JAX test's 2e-3. Global BA through the mesh on the map before the
loop (10 plain Schur-CG iterations in chunks of 3) equals the JAX package's
solve_ba_problem_dist on the same problem within 1e-3.

The System run (320x240, 130 frames, make_mesh(8), gates at 0) is `slow`,
like its JAX counterpart: every frame tracked, a loop closed, both sharded
paths taken, ATE under tests/test_dist_system.py's 0.12 m.
"""

import threading

import numpy as np
import pytest
import torch
from test_torch_loop_closing import CAM, _port_closer, loop_case, voc  # noqa: F401  (fixtures)

from orbslam2commentedbyxcm_tpu.models.local_mapping import assemble_ba_problem as j_assemble
from orbslam2commentedbyxcm_tpu.parallel import system_bridge as jbridge
from orbslam2commentedbyxcm_tpu.parallel.dist_ba import make_mesh as jmake_mesh
from orbslam2commentedbyxcm_tpu_torch.models import loop_closing as tloop_closing
from orbslam2commentedbyxcm_tpu_torch.models.gba import GlobalBA
from orbslam2commentedbyxcm_tpu_torch.models.map import Map
from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import make_mesh
from orbslam2commentedbyxcm_tpu_torch.utils import convert

torch.set_num_threads(1)


def test_global_ba_mesh_matches_jax(loop_case):  # noqa: F811
    before, _ = loop_case
    m = convert.map_from_jax(before["map"])
    kf_ids = [k.kf_id for k in m.good_keyframes()]
    problem_j = j_assemble(convert.map_from_jax(before["map"]), kf_ids, fixed_ids={m.origin_kf_id})
    res_j = jbridge.solve_ba_problem_dist(problem_j, CAM, jmake_mesh(4), abort_check=lambda: False)
    mesh = make_mesh(4, device="cpu")
    gba = GlobalBA(m, convert.camera_from_jax(CAM), threading.Lock(), mesh=mesh, dist_min_points=0)
    gba.launch(loop_kf_id=0)
    gba.wait()
    assert gba.n_completed == gba.n_distributed == 1 and gba.last_stats["distributed"]
    assert gba.last_stats["points"] == len(problem_j["pids"]) and mesh.n_psum > 0
    for kf_id, s in problem_j["kf_slot"].items():
        np.testing.assert_allclose(m.keyframes[kf_id].t_cw, res_j.poses[s], atol=1e-3)
    pids = problem_j["pids"]
    np.testing.assert_allclose(m.pt_xyz[pids], res_j.points[: len(pids)], atol=1e-3)
    moved = max(np.abs(m.keyframes[k].t_cw - before["map"].keyframes[k].t_cw).max() for k in kf_ids)
    assert moved > 1e-5


def test_global_ba_mesh_gate():
    """Below dist_min_points (default 2048) global BA stays single-device;
    a mesh on another device raises."""
    mesh = make_mesh(2, device="cpu")
    m = Map(device="cpu")
    gba = GlobalBA(m, convert.camera_from_jax(CAM), threading.Lock(), mesh=mesh)
    assert gba.dist_min_points == 2048 and gba.mesh is mesh and gba.n_distributed == 0
    with pytest.raises(ValueError, match="the mesh is on cpu"):
        GlobalBA(m, None, threading.Lock(), device="meta", mesh=mesh)


def test_loop_closing_mesh_matches_jax(loop_case, voc, monkeypatch):  # noqa: F811
    before, js = loop_case
    m, lc = _port_closer(before, voc)
    mesh = make_mesh(4, device="cpu")
    lc.mesh = lc.gba.mesh = mesh
    lc.dist_min_vertices = lc.gba.dist_min_points = 0
    graphs = []
    solve = tloop_closing.solve_pose_graph_dist

    def record(*args, **kw):
        graphs.append((args, solve(*args, **kw)))
        return graphs[-1][1]

    monkeypatch.setattr(tloop_closing, "solve_pose_graph_dist", record)
    lc.insert_keyframe(before["kf_id"])
    lc.gba.wait()
    jlc = js.loop_closing
    assert lc.n_loops_closed == jlc.n_loops_closed == 1
    assert lc.stats["posegraph_distributed"] == len(graphs) == 1
    assert {k: v for k, v in lc.stats.items() if k != "posegraph_distributed"} == {
        k: jlc.stats[k] for k in lc.stats if k != "posegraph_distributed"}
    assert lc.gba.n_completed == lc.gba.n_distributed == 1
    edges = {kf.kf_id: sorted(kf.loop_edges) for kf in m.keyframes.values() if kf.loop_edges}
    assert edges == {kf.kf_id: sorted(kf.loop_edges) for kf in js.map.keyframes.values() if kf.loop_edges}
    (poses, fixed, ei, ej, meas, mask, _), res = graphs[0]
    assert len(poses) == len(before["corrected"].good_keyframes())
    theirs = jbridge.solve_pose_graph_dist(poses, fixed, ei, ej, meas, mask, jmake_mesh(4), n_iters=20)
    np.testing.assert_allclose(res.poses.numpy(), np.asarray(theirs.poses), atol=2e-3)


def _mesh_system_run():
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

    cam = convert.camera_from_jax(CAM)
    seq = BoxSequence(camera=cam, n_frames=130, turns=1.3)
    cfg = TrackingConfig(n_features=600, max_frames_between_kf=4, kf_tracked_ratio=0.95, motion_search_radius=20.0)
    system = System(cam, Sensor.RGBD, config=cfg, vocabulary="bootstrap", mesh=make_mesh(8, device="cpu"),
                    device="cpu")
    system.loop_closing.dist_min_vertices = 0  # the sharded paths at this small size
    system.loop_closing.gba.dist_min_points = 0
    poses = [system.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) for i in range(seq.n_frames)]
    traj = system.frame_trajectory()
    est = np.stack([t for _, t in traj])
    gt = np.stack([seq.pose(int(round(ts * 30))) for ts, _ in traj])
    return system, poses, float(ate_rmse(positions_from_tcw(est), positions_from_tcw(gt), with_scale=False))


@pytest.mark.slow
def test_mesh_system_closes_loop():
    system, poses, ate = _mesh_system_run()
    system.shutdown()
    lc = system.loop_closing
    assert all(p is not None for p in poses)
    assert lc.n_loops_closed >= 1, lc.stats
    assert lc.stats["posegraph_distributed"] >= 1 and lc.gba.n_distributed >= 1
    assert ate < 0.12, f"ATE {ate:.3f} m over a mesh"
