"""The port's local mapping against the JAX package's, stage by stage, from one
map state.

The JAX System runs RGB-D SLAM on a 320x240 BoxSequence (seed 5) until it
inserts keyframe KF. There each mapping stage of the JAX LocalMapping runs
in turn, and the map is carried across (`convert.map_from_jax`) before and
after each one. The port's stage then runs on the copy taken before it, and
its result is held to the JAX result after it:

  create_new_map_points  the same new points (up to 1%), each with the same
                         observations and descriptor; positions within 0.1%
                         of their distance from the keyframe (90%), all
                         within 0.5%
  fuse_neighbors         the same surviving points (up to 1%), observation
                         counts within 1%
  local BA write-back    keyframe poses within 1e-3, points within 1 mm
                         (99%), erased observations within 1%
  cull_keyframes         the same erased keyframes, on the run's state and on
                         one with a redundant keyframe added (there the JAX
                         stage runs on the port's Map, which has its API)

Where the JAX map iterates `points_seen_by` in hash-set order, the port
iterates sorted ids: the fuse's reverse search can break a Hamming tie
between two points the other way, hence the 1% there. The triangulation
chooses between the DLT point and a depth backprojection by comparing two
cosines within ~1e-6 of 1, and float32 rounding in the two packages can put
a pair on either side: the point then passes the reprojection gate in one
package only. The DLT normal equations at 2-3 degrees of parallax amplify
the last-ulp differences of their float32 inputs along the viewing ray
(median 7e-5, worst 3e-3 of the distance on this run)."""

import copy

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models.local_mapping import LocalMapping as JLocalMapping
from orbslam2commentedbyxcm_tpu.models.system import Sensor as JSensor
from orbslam2commentedbyxcm_tpu.models.system import System as JSystem
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig as JConfig
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu_torch.models.local_mapping import LocalMapping
from orbslam2commentedbyxcm_tpu_torch.utils import convert

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
KF = 4  # inserted at frame 24 (a keyframe every 6 frames)
STAGES = ("create_new_map_points", "fuse_neighbors", "local_bundle_adjustment", "cull_keyframes")


class _Done(Exception):
    pass


@pytest.fixture(scope="module")
def snaps():
    """{stage: (map before, map after)} as port Maps, from the JAX run."""
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    system = JSystem(CAM, JSensor.RGBD, config=JConfig(n_features=600, max_frames_between_kf=6),
                     enable_loop_closing=False)
    lm = system.local_mapping
    lm.loop_closer = None
    insert = lm.insert_keyframe
    out = {}

    def insert_and_snapshot(kf_id):
        if kf_id != KF:
            return insert(kf_id)
        kf = lm.map.keyframes[kf_id]
        lm._track_recent_points(kf)
        lm.cull_map_points(kf)
        for stage in STAGES:
            before = convert.map_from_jax(lm.map)
            getattr(lm, stage)(kf)
            out[stage] = (before, convert.map_from_jax(lm.map))
        raise _Done

    lm.insert_keyframe = insert_and_snapshot
    with pytest.raises(_Done):
        for i in range(seq.n_frames):
            system.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0)
    return out


def _run_port(before, stage):
    m = convert.map_from_jax(before)  # a private copy: `before` stays as it was
    getattr(LocalMapping(m, convert.camera_from_jax(CAM)), stage)(m.keyframes[KF])
    return m


def test_create_new_map_points(snaps):
    before, ref = snaps["create_new_map_points"]
    got = _run_port(before, "create_new_map_points")
    def created(m):  # {observations: pid} of the points this stage created
        return {tuple(sorted(m.obs[p].items())): p for p in range(before.n_points, m.n_points)}

    new_ref, new_got = created(ref), created(got)
    common = sorted(set(new_ref) & set(new_got))
    print(f"created {len(new_ref)} points; the port {len(new_got)}, {len(common)} in common")
    assert len(new_ref) > 50
    assert len(set(new_ref) ^ set(new_got)) <= 0.01 * len(new_ref)
    r = np.array([new_ref[k] for k in common])
    g = np.array([new_got[k] for k in common])
    np.testing.assert_array_equal(got.pt_desc[g], ref.pt_desc[r])
    dist = np.linalg.norm(ref.pt_xyz[r] - before.keyframes[KF].center, axis=-1)
    rel = np.linalg.norm(got.pt_xyz[g] - ref.pt_xyz[r], axis=-1) / dist
    print(f"position |d| / distance: median {np.median(rel):.2e}, max {rel.max():.2e}")
    assert np.mean(rel <= 1e-3) >= 0.9 and rel.max() <= 5e-3
    assert abs(len(got.keyframes[KF].covis) - len(ref.keyframes[KF].covis)) == 0


def _n_obs(m):
    return sum(len(o) for o in m.obs.values())


def test_fuse_neighbors(snaps):
    before, ref = snaps["fuse_neighbors"]
    got = _run_port(before, "fuse_neighbors")
    ref_valid, got_valid = set(ref.all_point_ids()), set(got.all_point_ids())
    merged = before.n_valid_points() - ref.n_valid_points()
    changed = sum(ref.obs.get(p) != before.obs.get(p) for p in ref_valid)
    print(f"fuse: {merged} points merged, {changed} points gained observations; "
          f"port differs on {len(ref_valid ^ got_valid)} points")
    assert merged > 5 and changed > 20
    assert len(ref_valid ^ got_valid) <= 0.01 * len(ref_valid)
    assert abs(_n_obs(got) - _n_obs(ref)) <= 0.01 * _n_obs(ref)
    agree = [p for p in ref_valid & got_valid if got.obs[p] == ref.obs[p]]
    assert len(agree) >= 0.99 * len(ref_valid)


def test_local_ba_write_back(snaps):
    before, ref = snaps["local_bundle_adjustment"]
    got = _run_port(before, "local_bundle_adjustment")
    moved = 0
    for k, kf in ref.keyframes.items():
        np.testing.assert_allclose(got.keyframes[k].t_cw, kf.t_cw, atol=1e-3, rtol=0)
        moved += not np.array_equal(kf.t_cw, before.keyframes[k].t_cw)
    assert moved >= 2  # the local window moved; the origin stayed
    np.testing.assert_array_equal(got.keyframes[0].t_cw, before.keyframes[0].t_cw)
    pids = np.nonzero(ref.pt_valid & got.pt_valid)[0]
    err = np.linalg.norm(got.pt_xyz[pids] - ref.pt_xyz[pids], axis=-1)
    erased_ref, erased_got = _n_obs(before) - _n_obs(ref), _n_obs(before) - _n_obs(got)
    print(f"BA: {moved} poses moved, point |d| median {np.median(err):.2e} max {err.max():.2e}, "
          f"observations erased {erased_got} vs {erased_ref}")
    assert np.mean(err < 1e-3) >= 0.99
    assert abs(erased_got - erased_ref) <= max(3, 0.01 * _n_obs(ref))
    assert len(set(ref.all_point_ids()) ^ set(got.all_point_ids())) <= 0.01 * ref.n_valid_points()


def _with_clones(m, src=3, n=2):
    """`m` plus n copies of keyframe `src` that observe all of its points, so
    that `src` and its copies become redundant."""
    for _ in range(n):
        kf = copy.copy(m.keyframes[src])
        kf.kf_id, kf.covis, kf.parent, kf.children = m.next_kf_id, {}, None, set()
        kf.map_pt = np.full_like(kf.map_pt, -1)
        m.keyframes[kf.kf_id] = kf
        m.next_kf_id += 1
        for f in np.nonzero(m.keyframes[src].map_pt >= 0)[0]:
            m.add_observation(int(m.keyframes[src].map_pt[f]), kf.kf_id, int(f))
        m.update_connections(kf)
    m.update_connections(m.keyframes[KF])
    return m


@pytest.mark.parametrize("case", ["run", "redundant"])
def test_cull_keyframes(snaps, case):
    """On the run's own state (where nothing may be redundant) and with two
    copies of keyframe 3 added; the JAX stage runs on the same input."""
    before, ref = snaps["cull_keyframes"]
    if case == "redundant":
        before = _with_clones(convert.map_from_jax(before))
        ref = convert.map_from_jax(before)
        JLocalMapping(ref, CAM).cull_keyframes(ref.keyframes[KF])
    got = _run_port(before, "cull_keyframes")
    bad = sorted(k for k, kf in ref.keyframes.items() if kf.bad)
    print(f"{case}: erased keyframes {bad}")
    if case == "redundant":
        assert 3 in bad
    assert sorted(k for k, kf in got.keyframes.items() if kf.bad) == bad
    for k, kf in ref.keyframes.items():
        assert got.keyframes[k].parent == kf.parent and got.keyframes[k].covis == kf.covis
    assert got.obs == ref.obs


@pytest.mark.parametrize("abort", [True, False])
def test_interruptible_local_ba_matches_jax(snaps, abort, monkeypatch):
    """The abort flag (mbAbortBA) polled between LOCAL_BA_SCHEDULE's phases:
    raised before the local BA, the port's solve stops after its first
    phase, as the JAX package's _run_ba does (one bundle_adjustment call in
    each), and both write back the partial result; lowered, both run both
    phases. The JAX stage runs on a port Map (it has the JAX Map's API), so
    both start from the same state; the maps agree within the write-back
    test's bars."""
    import orbslam2commentedbyxcm_tpu.models.local_mapping as jlm_mod
    import orbslam2commentedbyxcm_tpu_torch.models.local_mapping as tlm_mod

    before, _ = snaps["local_bundle_adjustment"]
    calls = {"jax": 0, "port": 0}
    for mod, key in ((jlm_mod, "jax"), (tlm_mod, "port")):
        ba = mod.optim.bundle_adjustment

        def counted(*a, _ba=ba, _key=key, **k):
            calls[_key] += 1
            return _ba(*a, **k)

        monkeypatch.setattr(mod.optim, "bundle_adjustment", counted)
    got = convert.map_from_jax(before)
    lm = LocalMapping(got, convert.camera_from_jax(CAM))
    lm.abort_ba = abort
    lm.local_bundle_adjustment(got.keyframes[KF])
    ref = convert.map_from_jax(before)
    jl = JLocalMapping(ref, CAM)
    jl.abort_ba = abort
    jl.local_bundle_adjustment(ref.keyframes[KF])
    assert calls == ({"jax": 1, "port": 1} if abort else {"jax": 2, "port": 2})
    assert (lm.n_local_ba, lm.n_ba_aborted) == (1, int(abort))
    for k, kf in ref.keyframes.items():
        np.testing.assert_allclose(got.keyframes[k].t_cw, kf.t_cw, atol=1e-3, rtol=0)
    pids = np.nonzero(ref.pt_valid & got.pt_valid)[0]
    err = np.linalg.norm(got.pt_xyz[pids] - ref.pt_xyz[pids], axis=-1)
    print(f"abort {abort}: point |d| median {np.median(err):.2e} max {err.max():.2e}")
    assert np.mean(err < 1e-3) >= 0.99
    assert abs(_n_obs(got) - _n_obs(ref)) <= max(3, 0.01 * _n_obs(ref))
    moved = sum(not np.array_equal(kf.t_cw, before.keyframes[k].t_cw) for k, kf in got.keyframes.items())
    assert moved >= 2
