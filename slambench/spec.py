"""What a run measures, found by name from BENCHMARK.json.

A cell (`workloads` entry) names a configuration and a traffic mix; each is
a file of its own: `configs/<config>.json` (with the settings file it
names beside it) and `traffic/<traffic>.json`. Every metric, end-to-end or
per-layer, is a reader of its own, `metrics/<metric name>.py`, exposing
`read(run) -> float | None`. A later change adds a configuration, a mix or
a metric by adding files and entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration (with `settings_path`) and its
    traffic parameters; paths are relative to `root`, the checkout."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise SystemExit(f"slambench: workload {workload!r} is not in BENCHMARK.json")
    entry = entries[0]
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf_entry["file"])
    config["settings_path"] = str((root / conf_entry["file"]).parent / config["settings"])
    traffic = load_json(root / "slambench" / "traffic" / f"{entry['traffic']}.json")
    return {"entry": entry, "config": config, "traffic": traffic}


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of this cell reports: the end-to-end ones without
    tracing, the per-layer ones with it; a metric with a `workloads` list
    only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    """The `read(run)` function of slambench/metrics/<name>.py."""
    path = root / "slambench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise SystemExit(f"slambench: no reader {path} for metric {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
