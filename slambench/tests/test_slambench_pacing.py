"""The window's loop, flat out and at the camera's rate, and the percentiles."""

import numpy as np
import pytest

from slambench import pacing


class FakeClock:
    """A clock that only moves when the loop sleeps or a call takes time."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        assert s > 0
        self.t += s


def test_flat_out_sends_the_next_frame_at_the_last_ones_return_until_the_window_ends():
    clock = FakeClock()
    service = [0.010, 0.200, 0.010, 0.050, 0.010]

    def call(i):
        clock.t += service[i]
        return i != 3

    rec = pacing.run_window(0.25, 0.0, call, clock=clock, sleep=clock.sleep)
    # frames start at 0, 0.01, 0.21, 0.22; the window has passed 0.25 after the fourth
    assert rec.start == pytest.approx([0.0, 0.01, 0.21, 0.22])
    assert rec.end == pytest.approx([0.01, 0.21, 0.22, 0.27])
    assert rec.service_ms() == pytest.approx([10, 200, 10, 50])
    assert rec.queue_ms() == pytest.approx([0, 0, 0, 0], abs=1e-9)
    assert rec.ok.count(False) == 1
    assert rec.frames_per_s() == pytest.approx(4 / 0.27)


def test_flat_out_rate_moves_with_every_millisecond_of_service():
    rates = []
    for ms in (10.0, 11.0):
        clock = FakeClock()

        def call(i):
            clock.t += ms * 1e-3
            return True

        rates.append(pacing.run_window(5.0, 0.0, call, clock=clock, sleep=clock.sleep).frames_per_s())
    assert rates[0] == pytest.approx(100.0) and rates[1] == pytest.approx(1000.0 / 11.0, rel=2e-3)


def test_camera_pace_sleeps_ahead_and_queues_behind_a_stall():
    clock = FakeClock()
    service = {0: 0.010, 1: 0.200, 2: 0.010, 3: 0.010, 4: 0.010, 5: 0.010, 6: 0.010, 7: 0.010}

    def call(i):
        clock.t += service[i]
        return i != 3

    rec = pacing.run_window(0.8, 0.1, call, clock=clock, sleep=clock.sleep)
    assert rec.due == pytest.approx([0.1 * i for i in range(8)])
    # frame 1 stalls 200 ms: frame 2 (due 0.2) starts at 0.3, frame 3 at 0.31
    assert rec.start == pytest.approx([0.0, 0.1, 0.3, 0.31, 0.4, 0.5, 0.6, 0.7])
    assert rec.latency_ms() == pytest.approx([10, 200, 110, 20, 10, 10, 10, 10])
    assert rec.queue_ms() == pytest.approx([0, 0, 100, 10, 0, 0, 0, 0], abs=1e-9)
    assert rec.service_ms() == pytest.approx([10, 200, 10, 10, 10, 10, 10, 10])
    assert rec.ok.count(False) == 1


@pytest.mark.parametrize("period", [0.0, 1 / 30])
def test_a_raising_frame_counts_as_failed_and_the_stream_goes_on(period):
    clock = FakeClock()

    def call(i):
        clock.t += 0.04
        if i == 1:
            raise RuntimeError("lost")
        return True

    rec = pacing.run_window(0.1, period, call, clock=clock, sleep=clock.sleep)
    assert rec.ok == [True, False, True]
    assert len(rec.latency_ms()) == 3


@pytest.mark.parametrize("period", [0.0, 0.1])
def test_after_runs_once_per_frame_outside_the_timed_call(period):
    clock = FakeClock()
    seen = []

    def call(i):
        clock.t += 0.001
        return True

    def after(i):
        seen.append(i)
        clock.t += 0.11  # work after the return is not the frame's service time

    rec = pacing.run_window(0.3, period, call, clock=clock, sleep=clock.sleep, after=after)
    assert seen == [0, 1, 2]
    assert rec.service_ms() == pytest.approx([1, 1, 1])


def test_no_frame_no_rate():
    assert pacing.Record().frames_per_s() is None


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
@pytest.mark.parametrize("q", [0, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(n, q):
    xs = np.random.default_rng(n).exponential(10.0, n).tolist()
    assert pacing.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_of_nothing_is_none():
    assert pacing.percentile([], 50) is None
