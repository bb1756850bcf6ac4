"""The readers of the port's waits for the mapping side, on a hand-made
Run: `map_wait_pct.track` (hand-off and lock waits over the time inside
track_* calls), `map_lock_held_pct.mapping` (the mapping worker's lock hold
over the traced window) and `loop_worker_ms.p50`; each gives None without
what it reads (no device trace, or a port without the spans and counters)."""

import numpy as np
import pytest

from slambench import spec
from slambench.devtrace import TRACK_RANGE, Trace
from slambench.run import Run


def _trace():
    ns = lambda *x: np.array(x, np.int64)  # noqa: E731
    # a 2 s window; two track_* calls of 0.3 s and 0.5 s
    return Trace(
        window_s=2.0, dev_start=ns(0), dev_end=ns(10_000_000), dev_name=["k1_kernel"],
        track=ns(0, 300_000_000, 1_000_000_000, 1_500_000_000).reshape(2, 2),
        cpu_start=ns(0, 1_000_000_000), cpu_end=ns(300_000_000, 1_500_000_000), cpu_name=[TRACK_RANGE] * 2,
        cpu_thread=ns(1, 1), main_thread=1)


def _span(total_s, p50_ms=1.0):
    return {"n": 2, "total_s": total_s, "mean_ms": p50_ms, "p50_ms": p50_ms, "p95_ms": p50_ms}


def _run(stats, trace=True):
    run = Run({})
    run.tracer_stats = stats
    run.trace = _trace() if trace else None
    return run


STATS = {"spans": {"handoff_wait": _span(0.05), "lock_wait": _span(0.15), "tracking": _span(0.6),
                   "loop_worker": _span(0.4, p50_ms=180.5)},
         "counters": {"lock_hold_s.local-mapping": 0.5, "lock_holds.local-mapping": 3.0,
                      "lock_hold_s.tracking": 0.7, "lock_holds.tracking": 2.0}}
# what the port recorded before it timed its waits: no wait spans, no lock counters
PARENT_STATS = {"spans": {"tracking": _span(0.6), "local_mapping": _span(0.5)}, "counters": {}}


def test_map_wait_pct_track():
    read = spec.reader("map_wait_pct.track")
    assert read(_run(STATS)) == pytest.approx(100.0 * 0.2 / 0.8)
    only_lock = {"spans": {"lock_wait": _span(0.4)}, "counters": {}}
    assert read(_run(only_lock)) == pytest.approx(50.0)
    assert read(_run(STATS, trace=False)) is None
    assert read(_run(PARENT_STATS)) is None


def test_map_lock_held_pct_mapping():
    read = spec.reader("map_lock_held_pct.mapping")
    assert read(_run(STATS)) == pytest.approx(100.0 * 0.5 / 2.0)
    # a traced lock the mapping worker never held in the window
    no_mapping = {"spans": {}, "counters": {"lock_hold_s.tracking": 0.7, "lock_holds.tracking": 2.0}}
    assert read(_run(no_mapping)) == 0.0
    assert read(_run(STATS, trace=False)) is None
    assert read(_run(PARENT_STATS)) is None


def test_loop_worker_ms_p50():
    read = spec.reader("loop_worker_ms.p50")
    assert read(_run(STATS)) == 180.5
    assert read(_run(PARENT_STATS)) is None
    assert read(_run(None, trace=False)) is None
