"""On the card, at each cell's own size and window: the program's readings
stay within the limits, the control's (the reference in bfloat16 in the
program's place) fail them, and with loop closing switched off the loop
cell is not correct, on three seeds.

    python -m pytest slambench/tests/test_slambench_cuda.py -q   (on a machine with an H100)
"""

import io
import json

import pytest

from slambench import checks, control, spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_passes_at_cell_size(cuda, workload):
    out = io.StringIO()
    summary = control.readings(workload, SEEDS, BENCH["run_seconds"], out=out)
    lim = checks.limits()
    rows = [json.loads(line) for line in out.getvalue().splitlines()[:-1]]
    assert all(r["correct"] for r in rows) and not any(r["control_correct"] for r in rows)
    for name in ("extract_diff", "obs_diff", "pose_gap_px"):
        assert summary["lower"][name] <= lim[name] < summary["upper"][name], name


@pytest.mark.cuda
def test_a_loop_never_closed_is_not_correct_at_cell_size(cuda):
    out = io.StringIO()
    summary = control.readings("tum3_rgbd.office_loop", SEEDS, BENCH["run_seconds"], ["loop_off"], out=out)
    rows = [json.loads(line) for line in out.getvalue().splitlines()[:-1]]
    assert not any(r["correct"] for r in rows)
    assert summary["faults"]["loop_off"]["loops_closed"] == 0
