"""The reduction of a device trace: busy time as the union of the device
intervals, its share inside the harness's call intervals, kernel times by
name and the idle gaps."""

import numpy as np
import pytest

from slambench.devtrace import TRACK_RANGE, Trace


def _trace():
    ns = lambda *x: np.array(x, np.int64)  # noqa: E731
    # device: [0,10) k1, [5,12) k2 (overlaps), [20,25) k1, [40,41) copy
    return Trace(
        window_s=50e-9, dev_start=ns(0, 5, 20, 40), dev_end=ns(10, 12, 25, 41),
        dev_name=["k1_kernel", "k2_kernel", "k1_kernel", "Memcpy HtoD"],
        track=ns(0, 15, 18, 30).reshape(2, 2),
        cpu_start=ns(0, 18, 26, 13), cpu_end=ns(15, 30, 29, 19),
        cpu_name=[TRACK_RANGE, TRACK_RANGE, "aten::cat", "local_ba"],
        cpu_thread=ns(1, 1, 1, 2), main_thread=1)


def test_busy_is_the_union():
    t = _trace()
    assert t.busy().tolist() == [[0, 12], [20, 25], [40, 41]]
    assert t.busy_s() == pytest.approx(18e-9)


def test_busy_within_the_calls():
    t = _trace()
    # call [0, 15): busy 12; call [18, 30): busy 5
    assert t.busy_within(t.track) == pytest.approx(17e-9)
    assert t.busy_within(np.array([[11, 21], [24, 100]], np.int64)) == pytest.approx((1 + 1) * 1e-9 + (1 + 1) * 1e-9)


def test_kernel_time_by_name():
    t = _trace()
    s, n = t.kernel_time("k1_")
    assert n == 2 and s == pytest.approx(15e-9)
    assert t.kernel_time("nothing") == (0, 0)


def test_idle_gaps_are_named_by_the_harness_and_the_host():
    gaps = _trace().idle_gaps(5)
    assert [g[1] for g in gaps] == pytest.approx([15e-9, 8e-9])
    # [25, 40): middle 32, outside every call, nothing open
    assert gaps[0][0] == "between frames, waiting for the next due time"
    # [12, 20): middle 16, between the calls; a worker thread in local_ba
    assert gaps[1][0] == "between frames, waiting for the next due time; a worker thread in local_ba"
