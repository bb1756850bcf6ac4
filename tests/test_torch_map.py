"""The port's Map against the JAX package's Map: one scripted sequence of map
operations (add, observe, batch attribute updates, covisibility, replace,
erase, keyframe erasure with re-parenting, replacement resolution) run on
both, with exact results.

The JAX Map runs on its dict observation index (`_native = None`), the path
the port carries over. `points_seen_by` is compared as a set: the JAX
package's C++ index returns hash-set order and the port sorted ids."""

import types

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models.map import Map as JMap
from orbslam2commentedbyxcm_tpu_torch.models.map import Map as TMap

torch.set_num_threads(1)

N_KF, CAP = 7, 300


def _frames(rng):
    frames = []
    for k in range(N_KF):
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[:3, 3] = [-0.3 * k, 0.02 * k, 0.05 * (k % 2)]
        frames.append(types.SimpleNamespace(
            id=k, timestamp=float(k), camera=None, n_levels=8, scale_factor=1.2,
            uv=rng.uniform(0, 320, (CAP, 2)).astype(np.float32),
            uv_und=rng.uniform(0, 320, (CAP, 2)).astype(np.float32),
            angle=rng.uniform(-3, 3, CAP).astype(np.float32),
            level=rng.integers(0, 8, CAP).astype(np.int32),
            desc=rng.integers(0, 2**32, (CAP, 8), dtype=np.uint32),
            valid=np.ones(CAP, bool),
            u_right=np.full(CAP, -1.0, np.float32), depth=np.full(CAP, -1.0, np.float32),
            t_cw=t_cw, map_pt=np.full(CAP, -1, np.int64),
        ))
    return frames


def _script(m, rng, log):
    """Drive one Map through the operations; `log` collects return values."""
    for f in _frames(rng):
        m.add_keyframe(f)
    m.origin_kf_id = 0
    free = {k: list(rng.permutation(CAP)) for k in range(N_KF)}
    for _ in range(400):
        first = int(rng.integers(0, N_KF - 1))
        kfs = sorted({first, *rng.integers(first, min(first + 4, N_KF), int(rng.integers(1, 4))).tolist()})
        f0 = free[kfs[0]].pop()
        pid = m.add_point(rng.normal(0, 3, 3).astype(np.float32) + [0, 0, 8],
                          m.keyframes[kfs[0]].desc[f0], kfs[0])
        m.add_observation(pid, kfs[0], int(f0))
        for k in kfs[1:]:
            m.add_observation(pid, k, int(free[k].pop()))
    for k in range(N_KF):
        m.update_connections(m.keyframes[k], min_weight=40)
    every = m.all_point_ids()
    m.update_point_descriptors_batch(every)
    m.update_points_batch(every)
    for pid in every[:30]:
        m.update_point_descriptor(int(pid))
        m.update_point_normal_depth(int(pid))
    m.pt_visible[every] = rng.integers(1, 9, len(every))
    m.pt_found[every] = rng.integers(0, 9, len(every))
    # replace chains a -> b -> c, and plain merges
    for a, b in rng.choice(every, (25, 2), replace=False):
        m.replace_point(int(a), int(b))
    for a, b in zip(every[:5], every[5:10]):
        m.replace_point(int(a), int(b))
    probe = np.concatenate([every[:60], every[95:150], [-1, -5]])
    log.append(m.resolve_replaced_batch(probe))
    # observation and point erasure (a point dies below 2 observations)
    for pid in every[100:140]:
        o = m.obs.get(int(pid))
        if o:
            m.erase_observation(int(pid), next(iter(o)))
    for pid in every[140:150]:
        m.erase_point(int(pid))
    log.append(m.resolve_replaced_batch(probe))
    for k in range(N_KF):
        m.update_connections(m.keyframes[k], min_weight=40)
    m.erase_keyframe(2)
    m.erase_keyframe(0)  # the origin stays
    for k in (1, 3, 4):
        m.update_connections(m.keyframes[k], min_weight=40)
    m.erase_keyframe(4)
    log.append(m.points_seen_by([1, 3, 5]))
    log.append(m.points_seen_by(range(N_KF)))


@pytest.fixture(scope="module")
def maps():
    jm = JMap(point_capacity=256)  # grows past its capacity during the script
    jm._native = None
    tm = TMap(device="cpu", point_capacity=256)
    jlog, tlog = [], []
    _script(jm, np.random.default_rng(3), jlog)
    _script(tm, np.random.default_rng(3), tlog)
    return jm, tm, jlog, tlog


def test_point_arrays_equal(maps):
    jm, tm, _, _ = maps
    assert tm.n_points == jm.n_points and tm.pt_version == jm.pt_version
    assert len(tm.pt_valid) == len(jm.pt_valid)
    for name in ("pt_xyz", "pt_desc", "pt_normal", "pt_dmin", "pt_dmax", "pt_valid", "pt_ref_kf",
                 "pt_first_kf", "pt_visible", "pt_found", "pt_replaced_by"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert 0 < tm.n_valid_points() == jm.n_valid_points() < tm.n_points
    assert (tm.pt_replaced_by >= 0).sum() >= 25


def test_observations_and_graph_equal(maps):
    jm, tm, _, _ = maps
    assert tm.obs == jm.obs
    assert sorted(tm.keyframes) == sorted(jm.keyframes)
    for k, jkf in jm.keyframes.items():
        tkf = tm.keyframes[k]
        np.testing.assert_array_equal(tkf.map_pt, jkf.map_pt)
        assert tkf.covis == jkf.covis and tkf.parent == jkf.parent and tkf.children == jkf.children
        assert tkf.bad == jkf.bad
        assert (tkf.t_child_parent is None) == (jkf.t_child_parent is None)
        if jkf.t_child_parent is not None:
            np.testing.assert_array_equal(tkf.t_child_parent, jkf.t_child_parent)
        assert tkf.best_covisible(3) == jkf.best_covisible(3)
    assert [k for k, kf in tm.keyframes.items() if kf.bad] == [2, 4]
    # erasing keyframe 2 re-parented its children
    assert any(kf.parent not in (None, 2, 4) for kf in tm.keyframes.values() if not kf.bad)


def test_queries_equal(maps):
    jm, tm, jlog, tlog = maps
    np.testing.assert_array_equal(tlog[0], jlog[0])  # resolve_replaced_batch, after replaces
    np.testing.assert_array_equal(tlog[1], jlog[1])  # ... and after erasures
    assert (tlog[0] == -1).sum() < (tlog[1] == -1).sum()
    for t, j in zip(tlog[2:], jlog[2:]):  # points_seen_by, as sets; the port's sorted
        assert set(t.tolist()) == set(j.tolist()) and len(t) == len(j) > 0
        assert np.all(np.diff(t) > 0)
    pids = tlog[3][::3]
    got = tm.pack_points(pids, 256)
    ref = jm.pack_points(pids, 256)
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), ref[1])
    for a, b in zip(got[:1] + got[2:], ref[:1] + ref[2:]):
        np.testing.assert_array_equal(a.numpy(), b)
