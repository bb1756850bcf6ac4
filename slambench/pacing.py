"""The measured window's loop and its statistics.

A traffic mix sends its frames in one of two ways (`"pace"`):
  flat_out  the next frame goes in as soon as the last call returned, as an
            offline replay of a recorded sequence runs: the frames done
            over the window's time is the rate the system sustains
  camera    frame i is due at the window's start plus i / fps; the loop
            sleeps while it is ahead and never skips a frame, so a stalled
            call delays the frames behind it (upstream
            Examples/RGB-D/rgbd_tum.cc paces its loop by the frame period
            the same way)
The window lasts `seconds`: flat out, frames go in until that time has
passed; paced, every frame due before it goes in. Either way the window
closes at the return of the last frame sent.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

PACES = ("flat_out", "camera")


@dataclass
class Record:
    due: list = field(default_factory=list)    # seconds after the window's start (flat out: the call's start)
    start: list = field(default_factory=list)  # call start, same clock
    end: list = field(default_factory=list)    # call return, same clock
    ok: list = field(default_factory=list)     # the call returned a pose

    def latency_ms(self) -> list:
        return [1e3 * (e - d) for d, e in zip(self.due, self.end)]

    def queue_ms(self) -> list:
        return [1e3 * (s - d) for d, s in zip(self.due, self.start)]

    def service_ms(self) -> list:
        return [1e3 * (e - s) for s, e in zip(self.start, self.end)]

    def frames_per_s(self) -> float | None:
        """Every frame sent over the time from the window's start to the
        last one's return."""
        return len(self.end) / self.end[-1] if self.end and self.end[-1] > 0 else None


def run_window(seconds: float, period: float, call, clock=time.perf_counter, sleep=time.sleep, on_start=None,
               after=None) -> Record:
    """call(i) for i = 0, 1, ...; call returns True when it gave a pose.
    period 0: flat out, frames sent until `seconds` have passed; period > 0:
    frame i due at start + i * period, every frame due before `seconds`
    sent. An exception in a call counts as no pose and the loop goes on.
    on_start(t0) runs once, at the window's start; after(i) right after
    frame i's return is taken."""
    rec = Record()
    t0 = clock()
    if on_start is not None:
        on_start(t0)
    i = 0
    while True:
        now = clock() - t0
        if period > 0:
            due = i * period
            if due >= seconds:
                break
            if due > now:
                sleep(due - now)
        else:
            if now >= seconds:
                break
            due = now
        s = clock()
        try:
            ok = bool(call(i))
        except Exception as exc:  # a failed frame is counted, the stream goes on
            print(f"slambench: frame {i} raised {type(exc).__name__}: {exc}", flush=True)
            ok = False
        e = clock()
        rec.due.append(due)
        rec.start.append(s - t0)
        rec.end.append(e - t0)
        rec.ok.append(ok)
        if after is not None:
            after(i)
        i += 1
    return rec


def percentile(values, q: float) -> float | None:
    """The q-th percentile, linear between the two nearest ranks (numpy's
    default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
