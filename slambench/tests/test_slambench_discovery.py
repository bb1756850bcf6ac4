"""A traffic mix and a per-layer metric added as new files (and entries in
BENCHMARK.json) are found by name, with no file of the harness edited."""

import io
import json

from slambench import run, spec

NEW_MIX = {
    "why": "a faster orbit at the camera's rate",
    "pace": "camera",
    "trajectory": "orbit", "radius_m": 1.0, "speed_m_s": 0.4, "bob_m": 0.05, "bob_period_s": 7.854,
    "warmup_s": 1.0, "sample_frames": 4,
}
NEW_METRIC = '''"""Share of the window's frames that returned a pose."""


def read(run):
    return 100.0 * run.record.ok.count(True) / len(run.record.ok)
'''


def test_a_new_mix_and_metric_are_found_by_name(small_root):
    (small_root / "slambench" / "traffic" / "orbit_fast.json").write_text(json.dumps(NEW_MIX))
    (small_root / "slambench" / "metrics" / "tracked_pct.window.py").write_text(NEW_METRIC)
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tum3_rgbd.orbit_fast", "config": "tum3_rgbd", "traffic": "orbit_fast",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "tracked_pct.window", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "System (models/system)", "moves": "frames_per_s",
                               "workloads": ["tum3_rgbd.orbit_fast"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = spec.load_json(small_root / "BENCHMARK.json")
    cell = spec.cell(bench, "tum3_rgbd.orbit_fast", small_root)
    assert cell["traffic"]["speed_m_s"] == 0.4 and cell["config"]["sensor"] == "rgbd"
    names = [m["name"] for m in spec.metrics_for(bench, "tum3_rgbd.orbit_fast", trace=True)]
    assert "tracked_pct.window" in names and "service_ms.p50" not in names
    assert "tracked_pct.window" not in [m["name"] for m in spec.metrics_for(bench, "tum3_rgbd.revisit", True)]

    out, err = io.StringIO(), io.StringIO()
    rc = run.run_cell("tum3_rgbd.orbit_fast", 2**31 + 11, 2.0, True, device="cpu", root=small_root, out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["metrics"]["tracked_pct.window"]["unit"] == "%"
    assert 0 < result["metrics"]["tracked_pct.window"]["value"] <= 100
    # the metrics whose `workloads` leave this cell out are not read in it
    assert set(result["metrics"]) == {"tracked_pct.window"}
    assert list(result)[-1] == "checks"
