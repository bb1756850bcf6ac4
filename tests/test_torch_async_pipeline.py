"""The port's async pipeline (models/async_pipeline): local mapping and loop
closing on worker threads, against the JAX package's behaviour.

Stand-in stages check the mechanics: the loop worker's BoW phase runs without
the map lock; AsyncMapping.insert_keyframe raises the abort flag and
`accepts_keyframes()` turns false at QUEUE_CAP queued keyframes; with newer
keyframes queued, LocalMapping defers fuse and BA; each queued keyframe is
taken up by the mapping worker before the next frame takes the map lock
(`wait_taken`). One divergence from the JAX package is stated here: a
stage's exception reaches `wait_idle()` and `shutdown()` (the JAX workers
print it and go on), while the worker still
drains the rest of its queue. The keyframe policy meets a full mapper as the
JAX package's does: on the same inputs both interrupt the mapper's BA and
defer. A 30-frame RGB-D System at 320x240 with 600 features (loop closing
on, the vocabulary trained lazily from the map, so both workers run) tracks
as well as the synchronous port does (ATE within 1.5x + 1 cm), resets and
goes on, and `shutdown()` joins both workers."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models.tracking import Tracking as JTracking
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu_torch.models import system as tsystem
from orbslam2commentedbyxcm_tpu_torch.models.async_pipeline import QUEUE_CAP, AsyncLoopClosing, AsyncMapping
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig as TConfig
from orbslam2commentedbyxcm_tpu_torch.utils import convert
from orbslam2commentedbyxcm_tpu_torch.utils.evaluation import ate_rmse, positions_from_tcw

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
CFG = dict(n_features=600, max_frames_between_kf=6)
N = 30


def _system(**kw):
    return tsystem.System(convert.camera_from_jax(CAM), tsystem.Sensor.RGBD, config=TConfig(**CFG),
                          device="cpu", **kw)


def _track(s, seq, frames, t0=0.0):
    est, gt = [], []
    for i in frames:
        pose = s.track_rgbd(seq.render(i), seq.depth_map(i), t0 + i / 30.0)
        if pose is not None:
            est.append(pose)
            gt.append(seq.pose(i))
    return est, gt


def test_loop_detection_does_not_hold_map_lock():
    """The loop worker's prepare phase (the BoW transform) runs outside the
    map lock, so tracking goes on meanwhile (reference: the map mutex is
    taken only in CorrectLoop, src/LoopClosing.cc:497)."""
    started, release = threading.Event(), threading.Event()

    class SlowPrepare:
        def prepare_keyframe(self, kf_id):
            started.set()
            assert release.wait(timeout=10.0)
            return None  # nothing to do under the lock

    lock = threading.Lock()
    worker = AsyncLoopClosing(SlowPrepare(), lock)
    try:
        worker.insert_keyframe(0)
        assert started.wait(timeout=10.0)
        assert lock.acquire(timeout=1.0), "map lock held during the prepare phase"
        lock.release()
    finally:
        release.set()
        worker.shutdown()
    assert not worker._thread.is_alive()


def test_insert_raises_abort_and_queue_cap_refuses():
    """AsyncMapping.insert_keyframe sets the stage's abort flag (reference
    LocalMapping::InsertKeyFrame, src/LocalMapping.cc:117); with QUEUE_CAP
    keyframes queued the mapper accepts no more."""
    started, gate = threading.Event(), threading.Event()

    class Stub:
        abort_ba = False
        pending_check = None

        def insert_keyframe(self, kf_id):
            started.set()
            assert gate.wait(timeout=10.0)

    stub = Stub()
    am = AsyncMapping(stub, threading.Lock())
    try:
        assert stub.pending_check is not None and not stub.pending_check()
        am.insert_keyframe(1)
        assert stub.abort_ba
        stub.abort_ba = False
        assert started.wait(timeout=10.0) and am.accepts_keyframes()
        for k in range(2, 2 + QUEUE_CAP):  # keyframe 1 is on the worker, these wait
            am.insert_keyframe(k)
        assert stub.abort_ba and stub.pending_check()
        assert not am.accepts_keyframes() and am.max_depth == QUEUE_CAP
    finally:
        gate.set()
        am.shutdown()
    assert am.accepts_keyframes() and not am._thread.is_alive()


def test_mapping_worker_takes_each_keyframe_before_the_next_frame():
    """`wait_taken` (called by the System before a frame takes the map lock)
    returns only once the worker holds the lock for every queued keyframe,
    so a tracking thread that takes the lock again at once cannot keep a
    keyframe waiting for several frames."""
    gate = threading.Event()

    class Stub:
        abort_ba = False
        pending_check = None

        def insert_keyframe(self, kf_id):
            assert gate.wait(timeout=10.0)

    lock = threading.Lock()
    am = AsyncMapping(Stub(), lock)
    try:
        am.wait_taken()  # nothing queued
        with lock:  # the frame that queues the keyframe holds the lock
            am.insert_keyframe(3)
        am.wait_taken()
        assert lock.locked() and not lock.acquire(timeout=0.2)  # the worker holds it for keyframe 3
    finally:
        gate.set()
        am.shutdown()
    am.wait_taken()


def test_async_system_waits_for_the_mapping_worker(monkeypatch):
    """System(async_mapping=True) calls `wait_taken` before every frame
    takes the map lock."""
    calls = []
    real = AsyncMapping.wait_taken
    monkeypatch.setattr(AsyncMapping, "wait_taken", lambda self: calls.append(1) or real(self))
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    s = _system(enable_loop_closing=False, async_mapping=True)
    try:
        _track(s, seq, range(4))
    finally:
        s.shutdown()
    assert len(calls) == 4


def test_pending_work_defers_fuse_and_ba():
    """With newer keyframes queued, fuse, BA and culling wait (reference Run
    loop, src/LocalMapping.cc:63-82); the abort flag resets before the BA."""
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    s = _system(enable_loop_closing=False)
    _track(s, seq, range(8))
    lm = s.local_mapping
    lm.loop_closer = None
    calls = []
    lm.fuse_neighbors = lambda kf: calls.append("fuse")
    lm.local_bundle_adjustment = lambda kf: calls.append("ba")
    lm.cull_keyframes = lambda kf: calls.append("cull")
    kf_id = max(k.kf_id for k in s.map.good_keyframes())
    lm.pending_check = lambda: True
    lm.abort_ba = True
    lm.insert_keyframe(kf_id)
    assert calls == [] and lm.n_ba_deferred == 1 and not lm.abort_ba
    lm.pending_check = lambda: False
    lm.insert_keyframe(kf_id)
    assert calls == ["fuse", "ba", "cull"]


def test_stage_error_reaches_wait_idle_and_shutdown():
    """Divergence from the JAX package (async_pipeline.py:70-71, which only
    prints it): a stage's exception is raised again by wait_idle() and by
    shutdown(), as GlobalBA.wait() does; the worker drains the rest."""
    done = []

    class Flaky:
        abort_ba = False
        pending_check = None

        def insert_keyframe(self, kf_id):
            if kf_id in (1, 5):
                raise ValueError(f"stage failed on {kf_id}")
            done.append(kf_id)

    am = AsyncMapping(Flaky(), threading.Lock())
    for k in (1, 2, 3):
        am.insert_keyframe(k)
    with pytest.raises(RuntimeError, match="local-mapping stage failed") as err:
        am.wait_idle()
    assert isinstance(err.value.__cause__, ValueError) and "on 1" in str(err.value.__cause__)
    assert done == [2, 3]
    am.wait_idle()  # reported once
    am.insert_keyframe(5)
    am.insert_keyframe(6)
    with pytest.raises(RuntimeError) as err:
        am.shutdown()
    assert "on 5" in str(err.value.__cause__) and done == [2, 3, 6]
    assert not am._thread.is_alive()


@pytest.mark.parametrize("case", ["full", "accepts", "no_keyframe_wanted"])
def test_keyframe_policy_meets_a_full_mapper_as_jax(case):
    """Tracking._need_new_keyframe against the JAX package's on the same
    tracker state (the JAX method runs on the port's Tracking and Map, which
    have its attributes): a wanted keyframe with a full mapper interrupts the
    mapper's BA and is deferred; with room it is inserted; an unwanted one
    touches nothing."""
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    s = _system(enable_loop_closing=False)
    _track(s, seq, range(8))
    t = s.tracking
    frame = t.last_frame
    t.frames_since_kf = 0 if case == "no_keyframe_wanted" else t.cfg.max_frames_between_kf

    class Mapper:
        def __init__(self):
            self.interrupts = 0

        def accepts_keyframes(self):
            return case != "full"

        def interrupt_ba(self):
            self.interrupts += 1

    decisions = []
    for fn in (tsystem.Tracking._need_new_keyframe, JTracking._need_new_keyframe):
        t.local_mapper = Mapper()
        decisions.append((fn(t, frame), t.local_mapper.interrupts))
    assert decisions[0] == decisions[1]
    assert decisions[0] == {"full": (False, 1), "accepts": (True, 0), "no_keyframe_wanted": (False, 0)}[case]
    assert t.n_kf_deferred == (case == "full")


def test_async_system_tracks_resets_and_shuts_down():
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    sync = _system()
    est, gt = _track(sync, seq, range(N))
    sync.shutdown()
    sync_ate = ate_rmse(positions_from_tcw(np.stack(est)), positions_from_tcw(np.stack(gt)), with_scale=False)

    s = _system(async_mapping=True)
    assert isinstance(s.local_mapping, AsyncMapping)
    est, gt = _track(s, seq, range(N))
    traj = s.frame_trajectory()  # drains both queues
    ate = ate_rmse(positions_from_tcw(np.stack([p for _, p in traj])),
                   positions_from_tcw(np.stack([seq.pose(int(round(ts * 30))) for ts, _ in traj])), with_scale=False)
    lm = s.local_mapping
    print(f"async: {len(est)}/{N} tracked, ATE {ate:.4f} m (sync {sync_ate:.4f}), "
          f"{len(s.map.good_keyframes())} keyframes, {lm.n_local_ba} local BAs ({lm.n_ba_aborted} aborted, "
          f"{lm.n_ba_deferred} deferred), {s.tracking.n_kf_deferred} keyframes deferred, deepest queue "
          f"{lm.max_depth}")
    assert len(est) >= N - 2
    assert len(s.map.good_keyframes()) >= 3 and lm.n_local_ba >= 2
    assert ate <= 1.5 * sync_ate + 0.01
    # the lazy trainer ran on the mapping worker and started the loop worker
    assert s.vocabulary is not None and isinstance(s.local_mapping.loop_closer, AsyncLoopClosing)
    loop_worker = s._loop_worker
    assert loop_worker._thread.is_alive() and len(s.keyframe_db) >= 4

    s.reset()
    assert s.map.n_valid_points() == 0 and s.get_tracking_state() == tsystem.TrackingState.NOT_INITIALIZED
    est2, _ = _track(s, seq, range(20), t0=10.0)
    assert len(est2) >= 18 and len(s.map.good_keyframes()) >= 2
    s.shutdown()
    assert not lm._thread.is_alive() and not loop_worker._thread.is_alive()


def test_stages_under_thread_switch_stress():
    """A mapping and a loop stage chained as the System chains them, fed by
    more producer threads than cores with a shortened switch interval: every
    keyframe is mapped once and handed on once, in each producer's order,
    and the map-lock invariant holds (no stage runs while another holds it)."""
    import os
    import sys

    lock = threading.Lock()
    mapped, closed, inside = [], [], [0]

    class Loop:
        def prepare_keyframe(self, kf_id):
            return SimpleNamespace(kf_id=kf_id, bad=False)

        def detect_candidates(self, kf):
            assert lock.locked()
            return []

        def finalize(self, kf, found):
            assert lock.locked() and found is None
            closed.append(kf.kf_id)

    loop = AsyncLoopClosing(Loop(), lock)

    class Mapper:
        abort_ba = False
        pending_check = None

        def insert_keyframe(self, kf_id):
            inside[0] += 1
            assert inside[0] == 1 and lock.locked()
            mapped.append(kf_id)
            inside[0] -= 1
            loop.insert_keyframe(kf_id)

    am = AsyncMapping(Mapper(), lock)
    n_threads, per = 2 * (os.cpu_count() or 2), 50
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def produce(t):
            for k in range(per):
                with lock:  # the tracking thread enqueues under the map lock
                    am.insert_keyframe(t * per + k)
                am.accepts_keyframes()

        threads = [threading.Thread(target=produce, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        am.shutdown()
        loop.shutdown()
    finally:
        sys.setswitchinterval(interval)
    assert not am._thread.is_alive() and not loop._thread.is_alive()
    assert sorted(mapped) == sorted(closed) == list(range(n_threads * per))
    for t in range(n_threads):
        mine = [k for k in mapped if k // per == t]
        assert mine == sorted(mine)
