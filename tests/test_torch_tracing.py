"""The port's Tracer against the JAX package's, and the spans a System run
records in each package.

Both tracers get the same span and count calls (their span times are host
wall clock, so only the keys, the span counts and the counters can agree);
a disabled tracer records nothing; a 10-frame RGB-D run of each package's
System (320x240, 600 features, a keyframe at least every 6 frames, the
default lazy vocabulary trainer) records the same set of span names, one
"extract" and one "tracking" span and one frame record per frame. The port
adds three spans of its own around the Map's index queries
(`map_index_points`, `map_index_observers`, `map_index_connections`), which
the JAX package does not time."""

import json

import numpy as np
import torch

from orbslam2commentedbyxcm_tpu.models import system as jsystem
from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig as JConfig
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu.utils.tracing import Tracer as JTracer
from orbslam2commentedbyxcm_tpu_torch.models import system as tsystem
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig as TConfig
from orbslam2commentedbyxcm_tpu_torch.utils import convert
from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

torch.set_num_threads(1)

CAM = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
CFG = dict(n_features=600, max_frames_between_kf=6)


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
    assert [sorted(r) for r in rows_t] == [sorted(r) for r in rows_j]
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
    index_spans = {"map_index_points", "map_index_observers", "map_index_connections"}
    assert index_spans <= names_t and not index_spans & names_j
    assert names_t - index_spans == names_j
    assert {"extract", "tracking", "track_device", "local_mapping", "local_ba", "map_device"} <= names_t
    for name in ("extract", "tracking"):
        assert tt.stats()["spans"][name]["n"] == 10
    recs = tt.frame_records()
    assert len(recs) == 10 and all(r["state"] == "OK" and r["inliers"] > 0 for r in recs[1:])
    assert np.all(np.diff([r["frame"] for r in recs]) == 1)
