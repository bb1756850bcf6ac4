"""The port's Tracer against the JAX package's, and the spans a System run
records in each package.

Both tracers get the same span and count calls (their span times are host
wall clock, so only the keys, the span counts and the counters can agree);
a disabled tracer records nothing; a 10-frame RGB-D run of each package's
System (320x240, 600 features, a keyframe at least every 6 frames, the
default lazy vocabulary trainer) records the same set of span names, one
"extract" and one "tracking" span and one frame record per frame. The
port's span names, stats keys and dump rows are a superset of the JAX
package's: it adds three spans of its own around the Map's index queries
(`map_index_points`, `map_index_observers`, `map_index_connections`),
one around the tracking thread's wait for the map lock (`lock_wait`) and
one around the tracker's keyframe creation (`kf_create`), counters of the
map lock's holds, of the keyframe gate and of the grey conversion's path
(`grey_on_host` for these float32 frames), and a `kind` key on every dump
row.

The port alone: span records per thread with start and end stamps on the
profiler's clock, parent ids and causes (a worker's spans go into a
per-keyframe worker record, never into the open frame), the traced map lock
(`TracedLock`), and the async pipeline's hand-off and loop-worker spans."""

import json
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models import system as jsystem
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig as JConfig
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu.utils.tracing import Tracer as JTracer
from orbslam2commentedbyxcm_tpu_torch.models import system as tsystem
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig as TConfig
from orbslam2commentedbyxcm_tpu_torch.utils import convert
from orbslam2commentedbyxcm_tpu_torch.models.async_pipeline import AsyncMapping
from orbslam2commentedbyxcm_tpu_torch.utils.tracing import WORKER_ROLES, TracedLock, Tracer, acquired

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
CFG = dict(n_features=600, max_frames_between_kf=6)
# what the port records beyond the JAX package (see the module docstring)
PORT_SPANS = {"map_index_points", "map_index_observers", "map_index_connections", "lock_wait", "kf_create"}
PORT_COUNTERS = {"kf_inserted", "lock_hold_s.tracking", "lock_holds.tracking", "grey_on_host"}
PORT_ROW_KEYS = {"kind"}


def _feed(tracer):
    for f in range(3):
        tracer.begin_frame(f, f / 30.0)
        with tracer.span("extract"):
            pass
        for _ in range(f + 1):
            with tracer.span("tracking"):
                pass
        tracer.count("keyframes", 0.5 * f)
        tracer.end_frame(state="OK", inliers=10 * f)
    with tracer.span("outside"):  # no frame open
        pass
    tracer.count("loops")


def test_tracer_matches_jax(tmp_path):
    tt, jt = Tracer(), JTracer()
    _feed(tt)
    _feed(jt)
    st, sj = tt.stats(), jt.stats()
    assert st["counters"] == sj["counters"] == {"keyframes": 1.5, "loops": 1.0}
    assert st["spans"].keys() == sj["spans"].keys() == {"extract", "tracking", "outside"}
    for name in st["spans"]:
        assert st["spans"][name].keys() == sj["spans"][name].keys()
        assert st["spans"][name]["n"] == sj["spans"][name]["n"]
    assert st["spans"]["tracking"]["n"] == 6
    assert [(r["frame"], r["state"], r["inliers"], sorted(r["spans"])) for r in tt.frame_records()] == \
        [(r["frame"], r["state"], r["inliers"], sorted(r["spans"])) for r in jt.frame_records()]
    assert tt.summary_table().splitlines()[0] == jt.summary_table().splitlines()[0]
    assert len(tt.summary_table().splitlines()) == len(jt.summary_table().splitlines()) == 6
    tt.dump_jsonl(str(tmp_path / "t.jsonl"))
    jt.dump_jsonl(str(tmp_path / "j.jsonl"))
    rows_t = [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()]
    rows_j = [json.loads(line) for line in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert [sorted(set(r) - PORT_ROW_KEYS) for r in rows_t] == [sorted(r) for r in rows_j]
    assert [r["kind"] for r in rows_t] == ["frame"] * 3 + ["summary"]
    assert "summary" in rows_t[-1] and len(rows_t) == 4


def test_disabled_tracer_is_inert():
    t = Tracer(enabled=False)
    t.begin_frame(0)
    with t.span("x"):
        pass
    t.count("y")
    t.end_frame()
    assert t.stats() == {"spans": {}, "counters": {}}
    assert t.frame_records() == []


def test_system_span_names_match_jax():
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    jt, tt = JTracer(), Tracer()
    js = jsystem.System(CAM, jsystem.Sensor.RGBD, config=JConfig(**CFG), enable_loop_closing=False, tracer=jt)
    ts = tsystem.System(convert.camera_from_jax(CAM), tsystem.Sensor.RGBD, config=TConfig(**CFG),
                        enable_loop_closing=False, tracer=tt, device="cpu")
    for i in range(10):
        img, depth = seq.render(i), seq.depth_map(i)
        assert js.track_rgbd(img, depth, i / 30.0) is not None
        assert ts.track_rgbd(img, depth, i / 30.0) is not None
    js.shutdown()
    ts.shutdown()
    names_t, names_j = set(tt.stats()["spans"]), set(jt.stats()["spans"])
    print(f"port spans {sorted(names_t)}\nJAX spans {sorted(names_j)}")
    assert PORT_SPANS <= names_t and not PORT_SPANS & names_j
    assert names_t - PORT_SPANS == names_j
    for name in names_j:
        assert tt.stats()["spans"][name].keys() == jt.stats()["spans"][name].keys()
    counters_t, counters_j = set(tt.stats()["counters"]), set(jt.stats()["counters"])
    assert counters_t - counters_j == PORT_COUNTERS and counters_j <= counters_t
    assert {"extract", "tracking", "track_device", "local_mapping", "local_ba", "map_device"} <= names_t
    for name in ("extract", "tracking"):
        assert tt.stats()["spans"][name]["n"] == 10
    assert tt.stats()["counters"]["grey_on_host"] == 10  # the rendered frames are float32
    recs = tt.frame_records()
    assert len(recs) == 10 and all(r["state"] == "OK" and r["inliers"] > 0 for r in recs[1:])
    assert np.all(np.diff([r["frame"] for r in recs]) == 1)


def _on_thread(name, fn):
    """Run fn on a thread called `name` (a worker's role) and wait for it."""
    errors = []

    def body():
        try:
            fn()
        except Exception as exc:  # raised again below
            errors.append(exc)

    t = threading.Thread(target=body, name=name)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    if errors:
        raise errors[0]


def test_worker_spans_stay_out_of_the_frame():
    t = Tracer()
    t.begin_frame(7, 0.25)
    with t.span("extract"):
        pass

    def mapping():
        assert t.cause() is None  # no keyframe taken up yet on this thread
        with t.worker(3, t_cause["frame"]):
            assert t.cause() == 7
            with t.span("local_mapping"):
                with t.span("local_ba"):
                    pass

    t_cause = {"frame": t.cause()}  # the tracking thread: the open frame
    _on_thread("local-mapping", mapping)
    with t.span("tracking"):
        pass
    t.end_frame(state="OK")
    with t.span("outside"):  # no frame open, not a worker
        pass

    (frame,) = t.frame_records()
    assert frame["kind"] == "frame" and sorted(frame["spans"]) == ["extract", "tracking"]
    (rec,) = t.worker_records()
    assert (rec["kind"], rec["role"], rec["kf"], rec["frame"]) == ("worker", "local-mapping", 3, 7)
    assert sorted(rec["spans"]) == ["local_ba", "local_mapping"]
    by_name = {r["name"]: r for r in t.timeline()}
    assert [(by_name[n]["role"], by_name[n]["frame"], by_name[n]["kf"]) for n in ("extract", "local_ba", "outside")] \
        == [("tracking", 7, None), ("local-mapping", 7, 3), ("tracking", None, None)]
    assert t.stats()["spans"]["local_mapping"]["n"] == 1  # the totals see every thread


def test_parent_ids_and_stamps():
    t = Tracer()
    t.begin_frame(0)
    with t.span("a"):
        with t.span("b"):
            with t.span("c"):
                time.sleep(0.002)
        with t.span("d"):
            pass

    def other():
        with t.span("w"):  # its own stack: not a child of the tracking thread's "a"
            with t.span("w2"):
                pass

    with t.span("e"):
        _on_thread("loop-closing", other)
    t.end_frame()
    r = {x["name"]: x for x in t.timeline()}
    assert r["a"]["parent"] is None and r["e"]["parent"] is None and r["w"]["parent"] is None
    assert r["b"]["parent"] == r["d"]["parent"] == r["a"]["id"]
    assert r["c"]["parent"] == r["b"]["id"] and r["w2"]["parent"] == r["w"]["id"]
    assert len({x["id"] for x in r.values()}) == len(r)
    assert [x["name"] for x in t.timeline()] == ["a", "b", "c", "d", "e", "w", "w2"]  # by start
    for x in r.values():
        assert x["start_ns"] <= x["end_ns"]
    assert r["a"]["start_ns"] <= r["b"]["start_ns"] <= r["c"]["start_ns"] <= r["c"]["end_ns"] <= r["a"]["end_ns"]
    assert abs(r["a"]["start_ns"] - time.time_ns()) < 60e9  # the epoch clock of the profiler's events
    st = t.stats()["spans"]["c"]
    assert st["total_s"] == pytest.approx((r["c"]["end_ns"] - r["c"]["start_ns"]) * 1e-9)
    assert st["total_s"] >= 0.002


def _profiled(fn):
    """(name, start_ns, end_ns) of the CPU events torch.profiler records over fn()."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        fn()
    finally:
        prof.stop()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()]


def test_span_and_profiler_range_share_a_clock():
    t = Tracer()

    def body():
        with torch.profiler.record_function("probe_range"), t.span("probe"):
            time.sleep(0.005)

    events = {n: (s, e) for n, s, e in _profiled(body)}
    (rec,) = t.timeline()
    for s, e in (events["probe_range"], events["probe"], (rec["start_ns"], rec["end_ns"])):
        assert abs(s - events["probe_range"][0]) < 1_000_000 and abs(e - events["probe_range"][1]) < 1_000_000
    assert events["probe"][1] - events["probe"][0] >= 5_000_000


def test_traced_lock():
    t = Tracer()
    lock = TracedLock(t)
    taken, release = threading.Event(), threading.Event()
    waits = []

    def mapping():
        with lock:
            assert lock.locked() and lock.holder == "local-mapping"
            taken.set()
            release.wait(10)
            time.sleep(0.05)  # the tracking thread is waiting by now

    worker = threading.Thread(target=mapping, name="local-mapping")
    worker.start()
    assert taken.wait(10)
    assert lock.acquire(blocking=False) is False
    t0 = time.perf_counter()
    assert lock.acquire(timeout=0.01) is False
    assert time.perf_counter() - t0 >= 0.009

    def wait_for_it():
        t.begin_frame(1)
        release.set()
        with t.span("tracking"), acquired(t, lock):
            waits.append(lock.holder)
        t.end_frame()

    events = _profiled(wait_for_it)
    worker.join(10)
    assert not worker.is_alive() and not lock.locked() and lock.holder is None
    assert waits == ["tracking"]
    (wait,) = [r for r in t.timeline() if r["name"] == "lock_wait"]
    tracking = next(r for r in t.timeline() if r["name"] == "tracking")
    assert wait["holder"] == "local-mapping" and wait["parent"] == tracking["id"] and wait["frame"] == 1
    assert "lock_wait:local-mapping" in [n for n, _, _ in events]
    c = t.stats()["counters"]
    assert c["lock_holds.local-mapping"] == 1 and c["lock_holds.tracking"] == 1
    assert c["lock_hold_s.local-mapping"] >= 0.05
    assert t.frame_records()[0]["spans"]["lock_wait"] >= 0.01
    with acquired(t, lock):  # a free lock: no holder to wait for
        pass
    assert t.timeline()[-1]["holder"] is None
    assert t.stats()["counters"]["lock_holds.tracking"] == 2
    plain = threading.Lock()
    assert acquired(None, plain) is plain


def test_disabled_tracer_records_no_worker_or_lock():
    t = Tracer(enabled=False)
    lock = TracedLock(t)
    with t.worker(1, 2):
        assert t.cause() is None
        with t.span("x"), acquired(t, lock):
            pass
    assert lock.acquire(blocking=False)
    lock.release()
    assert t.stats() == {"spans": {}, "counters": {}}
    assert t.frame_records() == t.worker_records() == t.timeline() == []


def test_system_lock_is_plain_without_a_tracer():
    cam = convert.camera_from_jax(CAM)
    plain = tsystem.System(cam, tsystem.Sensor.RGBD, device="cpu")
    assert type(plain.map_lock) is type(threading.Lock())
    tt = Tracer()
    traced = tsystem.System(cam, tsystem.Sensor.RGBD, async_mapping=True, tracer=tt, device="cpu")
    assert isinstance(traced.map_lock, TracedLock) and traced.map_lock.tracer is tt
    assert traced.local_mapping.lock is traced.map_lock
    traced.shutdown()


def test_async_system_records_waits_workers_and_loop_spans(tmp_path):
    """12 RGB-D frames through the async pipeline with loop closing: every
    frame waits for the hand-off and the lock inside its own record, each
    keyframe's worker records carry it and the frame that inserted it, the
    loop worker's spans nest under `loop_worker`, and the hand-off to it is
    no `loop_closing` span."""
    seq = JBoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    tt = Tracer()
    s = tsystem.System(convert.camera_from_jax(CAM), tsystem.Sensor.RGBD,
                       config=TConfig(n_features=600, max_frames_between_kf=4), vocabulary="bootstrap",
                       async_mapping=True, tracer=tt, device="cpu")
    for i in range(12):
        assert s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) is not None
    s.shutdown()
    st = tt.stats()
    for name in ("handoff_wait", "lock_wait", "tracking", "extract"):
        assert st["spans"][name]["n"] == 12
    assert "loop_closing" not in st["spans"]
    frames = tt.frame_records()
    assert all({"handoff_wait", "lock_wait", "tracking"} <= set(r["spans"]) for r in frames)
    assert not any({"local_mapping", "loop_worker"} & set(r["spans"]) for r in frames)
    workers = tt.worker_records()
    mapped = [w for w in workers if w["role"] == "local-mapping"]
    looped = [w for w in workers if w["role"] == "loop-closing"]
    assert st["counters"]["kf_inserted"] == len(mapped) >= 2
    assert [w["kf"] for w in looped] == [w["kf"] for w in mapped]
    for w in mapped:
        assert w["frame"] == s.map.keyframes[w["kf"]].frame_id and "local_mapping" in w["spans"]
    for w in looped:
        assert w["frame"] == s.map.keyframes[w["kf"]].frame_id and "loop_worker" in w["spans"]
    rec = {r["id"]: r for r in tt.timeline()}
    for r in rec.values():
        if r["name"] in ("loop_prepare", "loop_detect", "loop_sim3", "loop_correct"):
            assert rec[r["parent"]]["name"] == "loop_worker" and r["role"] == "loop-closing"
        if r["name"] == "lock_wait":
            assert rec[r["parent"]]["name"] == "tracking"
    c = st["counters"]
    assert c["lock_holds.local-mapping"] == len(mapped) and c["lock_hold_s.local-mapping"] > 0
    assert c["lock_holds.tracking"] >= 12
    path = tmp_path / "t.jsonl"
    tt.dump_jsonl(str(path))
    kinds = [json.loads(line)["kind"] for line in path.read_text().splitlines()]
    assert kinds == ["frame"] * 12 + ["worker"] * len(workers) + ["summary"]


def test_span_labels_fit_a_gap_name():
    """Every span the port opens, and every lock_wait label, is at most 24
    characters: an idle gap's name keeps 64, and its prefix takes 38."""
    root = Path(__file__).resolve().parents[1] / "orbslam2commentedbyxcm_tpu_torch"
    names = set()
    for path in root.rglob("*.py"):
        names |= set(re.findall(r"""span\([^,()]+, ["']([^"']+)["']""", path.read_text()))
    assert {"tracking", "handoff_wait", "loop_worker", "loop_sim3", "map_index_connections"} <= names
    labels = names | {f"lock_wait:{role}" for role in WORKER_ROLES | {"tracking", "free"}}
    assert max(len(n) for n in labels) <= 24, sorted(labels, key=len)[-3:]


def test_queued_keyframes_carry_their_cause():
    """AsyncMapping queues each keyframe with the frame whose tracking
    inserted it, and the worker's spans over it form its worker record."""
    t = Tracer()

    class Stub:
        abort_ba = False

        def insert_keyframe(self, kf_id):
            with t.span("local_mapping"):
                pass

    am = AsyncMapping(Stub(), TracedLock(t), t)
    for frame, kf in ((4, 1), (9, 2)):
        t.begin_frame(frame)
        am.insert_keyframe(kf)
        am.wait_taken()
        t.end_frame()
    am.wait_idle()
    am.shutdown()
    assert [(w["kf"], w["frame"], w["role"], list(w["spans"])) for w in t.worker_records()] == \
        [(1, 4, "local-mapping", ["local_mapping"]), (2, 9, "local-mapping", ["local_mapping"])]
    assert t.stats()["counters"]["lock_holds.local-mapping"] == 2


def test_threads_lose_no_record():
    """16 threads (more than the cores) open spans and take the traced lock
    with a short switch interval: every span, hold and id is kept once."""
    import sys

    t = Tracer()
    lock = TracedLock(t)
    roles = ["local-mapping", "loop-closing", "global-ba", "other"]
    n_threads, n_iter = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body():
            for _ in range(n_iter):
                with t.span("outer"):
                    with lock:
                        with t.span("inner"):
                            pass

        threads = [threading.Thread(target=body, name=roles[i % 4]) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_iter
    st = t.stats()
    assert st["spans"]["outer"]["n"] == st["spans"]["inner"]["n"] == total
    assert sum(v for k, v in st["counters"].items() if k.startswith("lock_holds.")) == total
    assert st["counters"]["lock_holds.tracking"] == total // 4  # "other" records as tracking
    recs = t.timeline()
    assert len(recs) == 2 * total and len({r["id"] for r in recs}) == 2 * total
    by_id = {r["id"]: r for r in recs}
    assert all(by_id[r["parent"]]["name"] == "outer" and by_id[r["parent"]]["role"] == r["role"]
               for r in recs if r["name"] == "inner")
