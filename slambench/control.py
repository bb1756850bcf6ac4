"""The readings the limits of checks.py are set from.

    python3 slambench/control.py --workload tum3_rgbd.office_loop --seconds 30 --seeds 11 12 13 \
        --faults none local_ba_identity loop_off half_kf_obs

For each seed and each fault of faults.py ("none": the program as it is),
in one process: a run of the cell's window with the fault planted, then
every number of checks.py. For the program ("none") the numbers are read a
second time with the control, the reference computed in bfloat16, put in
the program's place on the same sampled frames. One JSON line per run, then
a summary line: the largest sound reading of each number and the smallest
reading of the control and of each fault. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slambench import faults, run as bench_run  # noqa: E402

NUMBERS = ("extract_diff", "obs_diff", "pose_gap_px", "kf_drift_cm", "map_gap_cm", "loops_closed")


def readings(workload: str, seeds, seconds: float, fault_names=("none",), device: str = "cuda", root: Path = ROOT,
             out=sys.stdout) -> dict:
    cell = bench_run.Cell(workload, root, device)
    missing = cell.cards_missing()
    if missing:
        raise SystemExit(missing)
    rows = []
    for seed in seeds:
        for name in fault_names:
            with faults.planted(name):
                done = bench_run.execute(cell, seed, seconds, trace=False, warm=not rows)
            numbers, _, correct, _ = bench_run.judged(cell, done, root=root)
            rec = done["run"].record
            row = {"seed": seed, "fault": name, "correct": correct, "program": numbers,
                   "frames": len(rec.ok), "failed": rec.ok.count(False), "frames_per_s": rec.frames_per_s(),
                   "keyframes": done["run"].keyframes}
            if name == "none":
                row["control"], _, row["control_correct"], _ = bench_run.judged(cell, done, "bf16", root=root)
            for k in ("program", "control"):  # per frame (gap px, inlier points) in the row, not the summary
                if k in row:
                    row[k + "_gaps"] = row[k].pop("pose_gaps")
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)

    def finite(xs):
        return [x for x in xs if x is not None and not (isinstance(x, float) and math.isnan(x))]

    def least(key, name=None):
        sel = [r for r in rows if name is None or r["fault"] == name]
        return {k: min(finite([r[key][k] for r in sel if key in r]), default=None) for k in NUMBERS}

    sound = [r for r in rows if r["fault"] == "none"]
    summary = {
        "workload": workload,
        "lower": {k: max(finite([r["program"][k] for r in sound]), default=None) for k in NUMBERS},
        "upper": least("control", "none"),
        "faults": {name: least("program", name) for name in fault_names if name != "none"},
        "pose_frames_min": min((r["program"]["pose_frames"] for r in sound), default=None),
    }
    print(json.dumps({"summary": summary}), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=["none"], choices=["none", *faults.FAULTS])
    args = ap.parse_args(argv)
    bench_run._env()
    readings(args.workload, args.seeds, args.seconds, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
