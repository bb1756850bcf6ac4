"""The slice as a whole: the port's LoopClosing against the JAX package's on
one shared map, plus global BA, the Sim3 cooldown, the candidate matcher and
map save / load across the two packages.

The JAX System (RGB-D, the shipped vocabulary, loop closing on) runs a
320x240 BoxSequence orbit of 1.3 turns over 110 frames until a keyframe
closes the loop (frame 87). Before every keyframe enters the JAX loop closer
the map is copied (`convert.map_from_jax`) with the closer's state, so the
port's LoopClosing gets the very map and state the JAX one closed the loop
from, and the JAX package's RANSAC draws (jax.random cannot be reproduced in
torch). Both maps keep the observation index in Python and list
`points_seen_by` in sorted order (the JAX run is told to; its C++ index lists
them in hash order), so ties break alike.

Bars: the same accepted candidate, loop edges and loop-closer stats; the
same points alive and every keyframe pose and point within 1e-3 once the
loop is corrected and fused (taken as the essential graph starts); every
keyframe pose within 1e-3 once the essential graph is optimized (taken as
global BA starts). There the points part on purpose (ROADMAP.md Queue 3):
the JAX package maps a point from the corrected group through the
pre-correction pose of its reference keyframe, which applies the loop
correction to it twice; the port maps each point from the pose its
reference keyframe entered the graph with (the corrected one for the group)
and a point the correction moved follows the keyframe that moved it, as the
reference does. So every point keeps its coordinates in that keyframe's
camera across the graph, and the points outside the group equal the JAX
package's within 1e-3. Global BA is held to the JAX package's
solve_ba_problem on the port's own corrected map: poses within 5e-2 (float32
alone puts each package 5e-3 to 8e-3 off a float64 solve of the first step
right after a loop), points within 5e-2 for 99% of them, all within 0.5 (the
far, thinly observed ones move most). Global BA on the map before the loop (10
plain iterations in chunks of 3) equals the JAX package's solve_ba_problem
within 1e-3; a stopped run writes nothing back; a failed one raises at wait(); a keyframe
added during the solve takes the correction through its parent. A
checkpoint written by either package loads in the other with the same
arrays.
"""

import copy
import threading

import jax
import numpy as np
import pytest
import torch
from test_torch_twoview import jax_samples

from orbslam2commentedbyxcm_tpu.models import map_io as jmap_io
from orbslam2commentedbyxcm_tpu.models.local_mapping import assemble_ba_problem as j_assemble
from orbslam2commentedbyxcm_tpu.models.local_mapping import solve_ba_problem as j_solve
from orbslam2commentedbyxcm_tpu.models.system import Sensor as JSensor
from orbslam2commentedbyxcm_tpu.models.system import System as JSystem
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig as JConfig
from orbslam2commentedbyxcm_tpu.utils.bucketing import bucket
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu_torch.models import map_io as tmap_io
from orbslam2commentedbyxcm_tpu_torch.models.gba import GlobalBA
from orbslam2commentedbyxcm_tpu_torch.models.keyframe_database import KeyFrameDatabase
from orbslam2commentedbyxcm_tpu_torch.models.local_mapping import assemble_ba_problem
from orbslam2commentedbyxcm_tpu_torch.models.loop_closing import LoopClosing, match_candidates
from orbslam2commentedbyxcm_tpu_torch.models.map import Map
from orbslam2commentedbyxcm_tpu_torch.ops import bow as tbow
from orbslam2commentedbyxcm_tpu_torch.ops import posegraph as tposegraph
from orbslam2commentedbyxcm_tpu_torch.utils import convert

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0, th_depth=50.0)
N_FRAMES, TURNS = 110, 1.3


class _Done(Exception):
    pass


@pytest.fixture(scope="module")
def loop_case():
    """The JAX System up to its first closed loop: the map and loop-closer
    state just before that keyframe entered the closer (as a port Map), and
    the live JAX System after the closure and its global BA."""
    seq = JBoxSequence(camera=CAM, n_frames=N_FRAMES, turns=TURNS)
    js = JSystem(CAM, JSensor.RGBD, config=JConfig(n_features=600, max_frames_between_kf=4, kf_tracked_ratio=0.95,
                                                   motion_search_radius=20.0),
                 vocabulary="bootstrap", enable_loop_closing=True)
    jm, jlc = js.map, js.loop_closing
    jm._native = None  # the dict-backed observation index, as the port's
    seen_by = jm.points_seen_by
    jm.points_seen_by = lambda ids: np.sort(seen_by(ids))
    closer_insert = jlc.insert_keyframe
    before = {}

    def insert(kf_id):
        snap = {"map": convert.map_from_jax(jm), "groups": copy.deepcopy(jlc.prev_consistent_groups),
                "cooldown": dict(jlc._sim3_cooldown), "last_loop": jlc.last_loop_kf_id, "stats": dict(jlc.stats),
                "key": jlc._key, "kf_id": kf_id}
        n_closed = jlc.n_loops_closed
        closer_insert(kf_id)
        if jlc.n_loops_closed > n_closed:
            before.update(snap)
            raise _Done

    jlc.insert_keyframe = insert
    gba_launch = jlc.gba.launch

    def launch(loop_kf_id):
        before["corrected"] = convert.map_from_jax(jm)  # loop corrected, essential graph optimized
        gba_launch(loop_kf_id)

    jlc.gba.launch = launch
    jax_eg = jlc._optimize_essential_graph

    def essential_graph(*args):
        before["pre_eg"] = convert.map_from_jax(jm)  # loop corrected and fused
        return jax_eg(*args)

    jlc._optimize_essential_graph = essential_graph
    with pytest.raises(_Done):
        for i in range(N_FRAMES):
            js.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0)
    jlc.gba.wait()  # outside the map lock, which the interrupted frame released
    assert jlc.gba.n_completed == 1
    return before, js


@pytest.fixture(scope="module")
def voc():
    return tbow.bootstrap_vocabulary()


def _port_closer(before, voc, m=None):
    """A port LoopClosing on a copy of the map before the closure, with the
    JAX closer's state and database (the good keyframes' BoW vectors)."""
    m = convert.map_from_jax(before["map"]) if m is None else m
    db = KeyFrameDatabase(voc)
    for kf in sorted(m.good_keyframes(), key=lambda k: k.kf_id):
        if kf.kf_id != before["kf_id"] and kf.bow_vec is not None:
            db.add(kf.kf_id, *kf.bow_vec)
    m.erase_hooks.append(db.erase)
    lc = LoopClosing(m, convert.camera_from_jax(CAM), keyframe_db=db, vocabulary=voc, fix_scale=True,
                     map_lock=threading.Lock(), device="cpu")
    lc.prev_consistent_groups = copy.deepcopy(before["groups"])
    lc._sim3_cooldown = dict(before["cooldown"])
    lc.last_loop_kf_id = before["last_loop"]
    lc.stats = {k: before["stats"][k] for k in lc.stats}
    _, sub = jax.random.split(before["key"])
    keys = jax.random.split(sub, LoopClosing.CAND_CAP)

    def jax_draws(mask, n_hypotheses):
        """The JAX closer's draws: lane i from keys[i] over the batch padded
        to its power-of-two bucket."""
        mk = mask.numpy()
        padded = np.zeros((len(mk), bucket(mk.shape[1])), bool)
        padded[:, : mk.shape[1]] = mk
        return torch.from_numpy(np.stack([jax_samples(keys[i], padded[i], n_hypotheses, 3)
                                          for i in range(len(mk))]))

    lc._draw_samples = jax_draws
    return m, lc


def _assert_maps_close(m, jm, atol, pt_atol=None, points=None):
    """Same keyframes and live points; poses within atol; the points (all
    live ones, or the live ones of the mask `points`) within atol, or with
    `pt_atol` = (99th percentile, max) bounds."""
    assert sorted(k.kf_id for k in m.good_keyframes()) == sorted(k.kf_id for k in jm.good_keyframes())
    for kf in m.good_keyframes():
        np.testing.assert_allclose(kf.t_cw, jm.keyframes[kf.kf_id].t_cw, atol=atol, err_msg=f"keyframe {kf.kf_id}")
    n = m.n_points
    assert jm.n_points == n
    np.testing.assert_array_equal(m.pt_valid[:n], jm.pt_valid[:n])
    valid = m.pt_valid[:n] if points is None else m.pt_valid[:n] & points[:n]
    if pt_atol is None:
        np.testing.assert_allclose(m.pt_xyz[:n][valid], jm.pt_xyz[:n][valid], atol=atol)
    else:
        d = np.abs(m.pt_xyz[:n][valid] - jm.pt_xyz[:n][valid]).max(axis=1)
        assert np.percentile(d, 99) <= pt_atol[0] and d.max() <= pt_atol[1], (np.percentile(d, 99), d.max())


def test_loop_closing_matches_jax(loop_case, voc, monkeypatch):
    before, js = loop_case
    m, lc = _port_closer(before, voc)
    pre_eg, corrected, graphs = [], [], []
    solve = tposegraph.solve_pose_graph
    monkeypatch.setattr(tposegraph, "solve_pose_graph", lambda *a, **k: graphs.append(solve(*a, **k)) or graphs[-1])
    essential_graph = lc._optimize_essential_graph

    def graph(kf, loop_kf_id, corrected_poses, non_corrected, loop_connections, corrected_by):
        pre_eg.append((convert.map_from_jax(m), corrected_poses, corrected_by))
        essential_graph(kf, loop_kf_id, corrected_poses, non_corrected, loop_connections, corrected_by)

    lc._optimize_essential_graph = graph
    gba_launch = lc.gba.launch
    lc.gba.launch = lambda loop_kf_id: corrected.append(convert.map_from_jax(m)) or gba_launch(loop_kf_id)
    lc.insert_keyframe(before["kf_id"])
    lc.gba.wait()
    jlc, jm = js.loop_closing, js.map
    assert lc.n_loops_closed == jlc.n_loops_closed == 1
    assert lc.stats == {k: jlc.stats[k] for k in lc.stats}, (lc.stats, jlc.stats)
    edges = {kf.kf_id: sorted(kf.loop_edges) for kf in m.keyframes.values() if kf.loop_edges}
    assert edges == {kf.kf_id: sorted(kf.loop_edges) for kf in jm.keyframes.values() if kf.loop_edges}
    split = lc.closure_splits[0]
    assert edges[before["kf_id"]] == [split["loop_kf_id"]] and split["kf_id"] == before["kf_id"]
    assert m.keyframes[split["loop_kf_id"]].not_erase and m.keyframes[before["kf_id"]].not_erase
    assert split["eg_vertices"] == len(m.good_keyframes()) and split["eg_iterations"] >= 1
    assert lc.last_loop_kf_id == jlc.last_loop_kf_id == before["kf_id"]
    assert lc.gba.n_completed == 1 and lc.gba.last_stats["chunks"] == 4
    pre, group, corrected_by = pre_eg[0]
    _assert_maps_close(pre, before["pre_eg"], atol=1e-3)

    # the essential graph: the JAX package's poses; each point keeps its
    # coordinates in the camera of the keyframe that moved it in the
    # correction, else of its reference keyframe, under that vertex's Sim3
    # before (the corrected pose) and after the graph
    post = corrected[0]
    n = post.n_points
    pids = np.nonzero(post.pt_valid[:n])[0]
    by = corrected_by[pids]
    ref = np.where(by >= 0, by, pre.pt_ref_kf[pids])
    vertices = sorted(k.kf_id for k in pre.good_keyframes())
    in_graph = np.isin(ref, vertices)
    assert in_graph.mean() > 0.99
    out = graphs[0].poses.numpy()
    for r in np.unique(ref[in_graph]):
        sel = pids[in_graph & (ref == r)]
        s_before, s_after = pre.keyframes[r].t_cw, out[vertices.index(r)]
        cam_before = pre.pt_xyz[sel] @ s_before[:3, :3].T + s_before[:3, 3]
        cam_after = post.pt_xyz[sel] @ s_after[:3, :3].T + s_after[:3, 3]
        np.testing.assert_allclose(cam_after, cam_before, atol=1e-3, err_msg=f"points of keyframe {r}")
    outside = np.zeros(n, bool)
    outside[pids[(by < 0) & ~np.isin(ref, list(group))]] = True
    _assert_maps_close(post, before["corrected"], atol=1e-3, points=outside)
    # the JAX package corrects the group's points a second time
    touched = pids[~outside[pids]]
    assert np.abs(post.pt_xyz[touched] - before["corrected"].pt_xyz[touched]).max() > 1e-2

    # global BA: the JAX package's solve on the same corrected map
    kf_ids = [k.kf_id for k in post.good_keyframes()]
    problem_j = j_assemble(convert.map_from_jax(post), kf_ids, fixed_ids={post.origin_kf_id})
    res_j = j_solve(problem_j, CAM, ((3, False), (3, False), (3, False), (1, False)),
                    abort_check=lambda: False, relabel_between=False)
    poses_j = np.asarray(res_j.poses)
    for kf_id, s in problem_j["kf_slot"].items():
        np.testing.assert_allclose(m.keyframes[kf_id].t_cw, poses_j[s], atol=5e-2, err_msg=f"keyframe {kf_id}")
    gp = problem_j["pids"]
    d = np.abs(m.pt_xyz[gp] - np.asarray(res_j.points)[: len(gp)]).max(axis=1)
    assert np.percentile(d, 99) <= 5e-2 and d.max() <= 0.5, (np.percentile(d, 99), d.max())


def _close_in_phases(before, voc, phased: bool):
    """A port closer on the map before the closure, run through
    insert_keyframe (process_prepared) or phase by phase as the async loop
    worker runs it; the live point coordinates are scrambled while try_close
    runs on the snapshot. Global BA is not started."""
    m, lc = _port_closer(before, voc)
    lc.gba.launch = lambda loop_kf_id: None
    kf_id = before["kf_id"]
    if not phased:
        lc.insert_keyframe(kf_id)
        return m, lc, None
    kf = lc.prepare_keyframe(kf_id)
    candidates = lc.detect_candidates(kf)
    snapshot = lc.snapshot_for_closure(kf, candidates)
    stats, cooldown = dict(lc.stats), dict(lc._sim3_cooldown)
    live = lc.try_close(kf, candidates)
    lc.stats, lc._sim3_cooldown = stats, cooldown  # the run below counts as the only one
    xyz = m.pt_xyz.copy()
    m.pt_xyz += 5.0  # the mapping worker moves the live map meanwhile
    found = lc.try_close(kf, candidates, snapshot=snapshot)
    m.pt_xyz[:] = xyz
    assert [c for c, _ in found] == [c for c, _ in live]
    for (_, a), (_, b) in zip(found, live):
        np.testing.assert_array_equal(a, b)
    lc.finalize(kf, found)
    return m, lc, (kf, candidates, snapshot, found)


def test_three_phases_equal_process_prepared(loop_case, voc):
    """detect_candidates + snapshot_for_closure + try_close(snapshot=) +
    finalize close the loop exactly as process_prepared does."""
    before, _ = loop_case
    m1, lc1, _ = _close_in_phases(before, voc, phased=False)
    m2, lc2, _ = _close_in_phases(before, voc, phased=True)
    assert lc1.n_loops_closed == lc2.n_loops_closed == 1
    assert lc1.stats == lc2.stats and lc1.last_loop_kf_id == lc2.last_loop_kf_id
    assert set(lc2.last_split) >= {"bow_transform", "detect", "snapshot", "ransac", "essential_graph"}
    assert [k.kf_id for k in m1.good_keyframes()] == [k.kf_id for k in m2.good_keyframes()]
    for kf in m1.keyframes.values():
        np.testing.assert_array_equal(kf.t_cw, m2.keyframes[kf.kf_id].t_cw)
        assert kf.loop_edges == m2.keyframes[kf.kf_id].loop_edges
    n = m1.n_points
    assert m2.n_points == n
    np.testing.assert_array_equal(m1.pt_valid[:n], m2.pt_valid[:n])
    np.testing.assert_array_equal(m1.pt_xyz[:n], m2.pt_xyz[:n])


def test_snapshot_try_close_matches_jax(loop_case, voc):
    """try_close on a snapshot against the JAX package's try_close(snapshot=)
    on the same map and candidates, with the same RANSAC draws: the same
    survivors, each corrected Sim3 within 1e-3."""
    from orbslam2commentedbyxcm_tpu.models.loop_closing import LoopClosing as JLoopClosing

    before, _ = loop_case
    m, lc = _port_closer(before, voc)
    kf = lc.prepare_keyframe(before["kf_id"])
    candidates = lc.detect_candidates(kf)
    assert candidates
    stats = dict(lc.stats)
    found = lc.try_close(kf, candidates, snapshot=lc.snapshot_for_closure(kf, candidates))
    jlc = JLoopClosing(m, CAM, fix_scale=True)
    jlc._sim3_cooldown = dict(before["cooldown"])
    jlc._key = before["key"]
    jfound = jlc.try_close(kf, candidates, snapshot=jlc.snapshot_for_closure(kf, candidates))
    print(f"candidates {candidates}: port {[c for c, _ in found]}, JAX {[c for c, _ in jfound]}")
    assert found and [c for c, _ in found] == [c for c, _ in jfound]
    for (_, a), (_, b) in zip(found, jfound):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3)
    assert {k: lc.stats[k] - stats[k] for k in lc.stats} == {k: jlc.stats[k] for k in lc.stats}


def test_global_ba_matches_jax_solve(loop_case):
    before, _ = loop_case
    m = convert.map_from_jax(before["map"])
    kf_ids = [k.kf_id for k in m.good_keyframes()]
    problem_j = j_assemble(convert.map_from_jax(before["map"]), kf_ids, fixed_ids={m.origin_kf_id})
    res_j = j_solve(problem_j, CAM, ((3, False), (3, False), (3, False), (1, False)),
                    abort_check=lambda: False, relabel_between=False)
    gba = GlobalBA(m, convert.camera_from_jax(CAM), threading.Lock())
    gba.launch(loop_kf_id=0)
    gba.wait()
    assert gba.n_completed == 1 and gba.last_stats["poses"] == len(kf_ids)
    poses_j = np.asarray(res_j.poses)
    for kf_id, s in problem_j["kf_slot"].items():
        np.testing.assert_allclose(m.keyframes[kf_id].t_cw, poses_j[s], atol=1e-3)
    pids = problem_j["pids"]
    np.testing.assert_allclose(m.pt_xyz[pids], np.asarray(res_j.points)[: len(pids)], atol=1e-3)
    moved = max(np.abs(m.keyframes[k].t_cw - before["map"].keyframes[k].t_cw).max() for k in kf_ids)
    assert moved > 1e-5


def test_global_ba_abort_discards(loop_case):
    before, _ = loop_case
    m = convert.map_from_jax(before["map"])
    poses = {kf.kf_id: kf.t_cw.copy() for kf in m.good_keyframes()}
    xyz = m.pt_xyz.copy()
    lock = threading.Lock()
    gba = GlobalBA(m, convert.camera_from_jax(CAM), lock)
    with lock:  # write-back cannot land before the stop
        gba.launch(loop_kf_id=0)
        gba.abort()
    gba.wait()
    assert gba.n_completed == 0 and gba.n_aborted == 1 and gba.full_ba_idx == 1
    for kf in m.good_keyframes():
        np.testing.assert_array_equal(kf.t_cw, poses[kf.kf_id])
    np.testing.assert_array_equal(m.pt_xyz, xyz)


def test_global_ba_error_reaches_wait(loop_case):
    """An exception inside the solve thread is raised by wait(), and the map
    is left as it was: a global BA never dies silently."""
    before, _ = loop_case
    m = convert.map_from_jax(before["map"])
    poses = {kf.kf_id: kf.t_cw.copy() for kf in m.good_keyframes()}
    gba = GlobalBA(m, None, threading.Lock())  # no camera: the solve raises
    gba.launch(loop_kf_id=0)
    with pytest.raises(RuntimeError, match="global BA failed") as err:
        gba.wait()
    assert isinstance(err.value.__cause__, AttributeError)
    assert gba.n_completed == 0 and not gba.running()
    gba.wait()  # raised once
    for kf in m.good_keyframes():
        np.testing.assert_array_equal(kf.t_cw, poses[kf.kf_id])


def test_global_ba_writes_back_only_under_the_lock(loop_case):
    """Stress: 12 threads (more than the cores) take the map lock in turn,
    with a short switch interval, while global BA solves and writes back.
    No holder ever sees a keyframe pose or a point change under the lock."""
    import sys
    import time

    before, _ = loop_case
    m = convert.map_from_jax(before["map"])
    lock = threading.Lock()
    gba = GlobalBA(m, convert.camera_from_jax(CAM), lock)
    kfs = m.good_keyframes()
    torn, stop = [], threading.Event()

    def holder():
        while not stop.is_set():
            with lock:
                poses = [kf.t_cw for kf in kfs]
                xyz = m.pt_xyz[:64].copy()
                time.sleep(0)
                if any(kf.t_cw is not p for kf, p in zip(kfs, poses)) or not np.array_equal(m.pt_xyz[:64], xyz):
                    torn.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=holder, daemon=True) for _ in range(12)]
    try:
        for t in threads:
            t.start()
        gba.launch(loop_kf_id=0)
        deadline = time.monotonic() + 120
        while gba.running() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(interval)
    gba.wait()
    assert not any(t.is_alive() for t in threads)
    assert gba.n_completed == 1 and not torn


def test_global_ba_propagates_to_new_keyframes(loop_case):
    """A keyframe created during the solve (absent from the snapshot) takes
    the correction through its spanning-tree parent (reference :745-775)."""
    before, _ = loop_case
    m = convert.map_from_jax(before["map"])
    kf_ids = [k.kf_id for k in m.good_keyframes()]
    problem = assemble_ba_problem(m, kf_ids, fixed_ids={m.origin_kf_id})
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 0.1
    poses = problem["poses"].copy()
    for s in problem["kf_slot"].values():
        poses[s] = shift @ poses[s]
    parent = m.keyframes[max(kf_ids)]
    new = copy.copy(parent)
    new.kf_id, new.parent, new.children, new.t_cw = m.next_kf_id, parent.kf_id, set(), parent.t_cw @ shift
    m.keyframes[new.kf_id] = new
    parent.children.add(new.kf_id)
    before_poses = {k: kf.t_cw.copy() for k, kf in m.keyframes.items()}
    GlobalBA(m, convert.camera_from_jax(CAM), threading.Lock())._propagate(problem, poses, problem["points"], m)
    np.testing.assert_allclose(parent.t_cw, shift @ before_poses[parent.kf_id], atol=1e-5)
    np.testing.assert_allclose(new.t_cw, shift @ before_poses[new.kf_id], atol=1e-4)


class _KF:
    """The query keyframe's stand-in: the cooldown gate reads kf_id only."""

    def __init__(self, kf_id):
        self.kf_id = kf_id


@pytest.mark.parametrize("case", ["skip-then-retry", "per-candidate"])
def test_sim3_cooldown(case):
    """tests/test_loop_cooldown.py's cases on the port: a rejected candidate
    is skipped for sim3_cooldown_kfs keyframes, then tried again, and the
    cooldown is per candidate."""
    lc = LoopClosing(Map(device="cpu"), camera=None, map_lock=threading.Lock())
    if case == "skip-then-retry":
        lc._sim3_cooldown[2] = 4 + lc.sim3_cooldown_kfs
        assert lc.try_close(_KF(5), [2]) is None
        assert (lc.stats["cooldown_skip"], lc.stats["sim3_tried"]) == (1, 0)
        assert lc.try_close(_KF(4 + lc.sim3_cooldown_kfs), [2]) is None
        assert (lc.stats["cooldown_skip"], lc.stats["sim3_tried"]) == (1, 1)
    else:
        lc._sim3_cooldown[7] = 10
        lc.try_close(_KF(6), [7, 8])
        assert (lc.stats["cooldown_skip"], lc.stats["sim3_tried"]) == (1, 1)


def test_candidate_matching_per_candidate_rule(rng):
    """Divergence from the JAX package (loop_closing.py:417-419, ROADMAP
    Queue 3): there one candidate without BoW grouping nodes drops the whole
    batch to plain Hamming matching. The port picks the rule per candidate:
    the candidate with nodes is matched as alone, the one without by plain
    Hamming, as each would be alone."""
    from orbslam2commentedbyxcm_tpu.ops import matching as jmatching

    m, t = 60, 80
    a = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    c = rng.integers(0, 2**32, (2, t, 8), dtype=np.uint32)
    c[:, :m] = a  # every query row has an exact twin in both candidates
    for i in range(m):  # ... a few bits off
        c[:, i, i % 8] ^= np.uint32(1 << (i % 31))
    a_nodes = rng.integers(0, 4, m)
    c_nodes = rng.integers(0, 4, (2, t))
    valid = np.ones((2, t), bool)
    idx, ok = match_candidates(convert.desc_to_torch(a), torch.from_numpy(a_nodes), convert.desc_to_torch(c),
                               torch.from_numpy(c_nodes), torch.from_numpy(valid), torch.tensor([True, False]))
    bow_idx, _, bow_ok = jmatching.search_by_bow(a, a_nodes.astype(np.int32), np.ones(m, bool), c[0],
                                                 c_nodes[0].astype(np.int32), valid[0])
    d = jmatching.hamming_matrix(a, c[1])
    nn_idx, _, nn_ok = jmatching.match_nn(d, np.ones(m, bool), valid[1], None, max_dist=jmatching.TH_LOW,
                                          ratio=0.75, mutual=True)
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(bow_ok))
    np.testing.assert_array_equal(idx[0].numpy()[ok[0].numpy()], np.asarray(bow_idx)[np.asarray(bow_ok)])
    np.testing.assert_array_equal(ok[1].numpy(), np.asarray(nn_ok))
    np.testing.assert_array_equal(idx[1].numpy()[ok[1].numpy()], np.asarray(nn_idx)[np.asarray(nn_ok)])
    assert ok[1].sum() > ok[0].sum() > 0  # the node gate only removes pairs


def _assert_checkpoints_equal(m, voc, traj, m2, voc2, traj2):
    n = m.n_points
    assert m2.n_points == n
    for name in ("pt_xyz", "pt_desc", "pt_valid", "pt_ref_kf", "pt_dmax", "pt_replaced_by"):
        np.testing.assert_array_equal(getattr(m2, name)[:n], getattr(m, name)[:n])
    assert sorted(m2.keyframes) == sorted(m.keyframes)
    for k, kf in m.keyframes.items():
        kf2 = m2.keyframes[k]
        for name in ("t_cw", "map_pt", "desc", "uv_und", "level", "u_right"):
            np.testing.assert_array_equal(getattr(kf2, name), getattr(kf, name))
        assert (kf2.parent, kf2.bad, set(kf2.loop_edges), kf2.children) == (kf.parent, kf.bad, set(kf.loop_edges),
                                                                              kf.children)
        assert kf2.covis == kf.covis
    assert {p: dict(o) for p, o in m2.obs.items()} == {p: dict(o) for p, o in m.obs.items()}
    for f in ("node_desc", "node_children", "word_weight", "word_node"):
        np.testing.assert_array_equal(getattr(voc2, f), getattr(voc, f))
    assert len(traj2) == len(traj)
    for a, b in zip(traj, traj2):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])


def test_map_checkpoints_cross_load(loop_case, tmp_path):
    """A checkpoint of the JAX System after the closure loads alike in both
    packages (covisibility recomputed from the observations by each); the
    port's map, saved by the port, loads in the JAX package the same."""
    from orbslam2commentedbyxcm_tpu.ops import bow as jbow

    _, js = loop_case
    # a small vocabulary trained on the map keeps the files small (the
    # System's 785,724-word tree would be 60 MiB to compress twice)
    small = jbow.train_vocabulary(np.concatenate([kf.desc[kf.valid] for kf in js.map.good_keyframes()]), k=4,
                                  depth=2)
    path = str(tmp_path / "jax.npz")
    jmap_io.save_map(js.map, path, vocabulary=small, trajectory=js.tracking.trajectory)
    m, voc, traj = tmap_io.load_map(path, device="cpu")
    _assert_checkpoints_equal(*jmap_io.load_map(path), m, voc, traj)
    assert sum(len(kf.loop_edges) for kf in m.keyframes.values()) == 2
    np.testing.assert_array_equal(m.pt_xyz[: m.n_points], js.map.pt_xyz[: m.n_points])
    path2 = str(tmp_path / "port.npz")
    tmap_io.save_map(m, path2, vocabulary=voc, trajectory=traj)
    _assert_checkpoints_equal(m, voc, traj, *jmap_io.load_map(path2))
