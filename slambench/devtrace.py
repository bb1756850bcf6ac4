"""The device trace of a `--trace 1` run, reduced to what the per-layer
readers need.

torch.profiler records CPU and CUDA activity over the measured window; the
harness marks each `track_*` call with a `record_function` range. From the
raw events (their start and duration in one host-clock timebase, the
device's converted by the profiler) this module keeps: every device
activity interval (kernels, copies, sets), the device time and launch count
per kernel name, and the CPU ranges, so that readers can intersect the
device's busy time with the harness's call intervals.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np

TRACK_RANGE = "slambench.track"


@dataclass
class Trace:
    window_s: float
    dev_start: np.ndarray   # ns, every device activity
    dev_end: np.ndarray
    dev_name: list
    track: np.ndarray       # (n, 2) ns, the harness's track_* calls
    cpu_start: np.ndarray   # ns, CPU events of every thread
    cpu_end: np.ndarray
    cpu_name: list
    cpu_thread: np.ndarray
    main_thread: int

    def busy(self) -> np.ndarray:
        """The union of the device intervals as (m, 2) ns, sorted."""
        if len(self.dev_start) == 0:
            return np.zeros((0, 2), np.int64)
        order = np.argsort(self.dev_start, kind="stable")
        s, e = self.dev_start[order], self.dev_end[order]
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        idx = np.flatnonzero(new)
        ends = np.maximum.reduceat(e, idx)
        return np.stack([starts, ends], 1)

    def busy_s(self) -> float:
        b = self.busy()
        return float((b[:, 1] - b[:, 0]).sum()) * 1e-9

    def busy_within(self, intervals: np.ndarray) -> float:
        """Seconds of device activity inside the (n, 2) ns intervals."""
        b = self.busy()
        if len(b) == 0 or len(intervals) == 0:
            return 0.0
        cum = np.concatenate([[0], np.cumsum(b[:, 1] - b[:, 0])])

        def covered_before(t):  # busy ns up to t: the segments before the last one starting at or
            # before t, and the part of that one up to t
            j = np.maximum(np.searchsorted(b[:, 0], t, side="right") - 1, 0)
            part = np.clip(t - b[j, 0], 0, b[j, 1] - b[j, 0])
            return np.where(t >= b[0, 0], cum[j] + part, 0)

        return float((covered_before(intervals[:, 1]) - covered_before(intervals[:, 0])).sum()) * 1e-9

    def kernels(self) -> dict:
        """{kernel name: (device seconds, launches)}."""
        out: dict = {}
        for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            t, c = out.get(n, (0.0, 0))
            out[n] = (t + (e - s) * 1e-9, c + 1)
        return out

    def kernel_time(self, substr: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds substr."""
        t = c = 0
        for n, (tt, cc) in self.kernels().items():
            if substr in n:
                t, c = t + tt, c + cc
        return t, c

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle gaps of the device inside the window, each named
        by where the harness was (inside a track_* call or waiting for the
        next frame's due time) and the innermost CPU range open at the gap's
        middle on any thread (the tracking thread's first)."""
        b = self.busy()
        if len(b) < 2:
            return []
        gaps = np.stack([b[:-1, 1], b[1:, 0]], 1)
        order = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:top]
        ops = np.array([n != TRACK_RANGE for n in self.cpu_name], bool)
        out = []
        for g0, g1 in gaps[order]:
            mid = (g0 + g1) // 2
            in_call = bool(((self.track[:, 0] <= mid) & (self.track[:, 1] >= mid)).any())
            name = "in a track_* call" if in_call else "between frames, waiting for the next due time"
            open_ = ops & (self.cpu_start <= mid) & (self.cpu_end >= mid)
            for on_main in (True, False):
                sel = open_ & ((self.cpu_thread == self.main_thread) == on_main)
                if sel.any():
                    i = np.flatnonzero(sel)[np.argmax(self.cpu_start[sel])]
                    name += f"; {'tracking' if on_main else 'a worker'} thread in {self.cpu_name[i]}"
                    break
            out.append([name, float(g1 - g0) * 1e-9])
        return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over the block (CPU and CUDA activity) when enabled;
    yields a holder whose `.trace` is set after the block."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.time_ns()
    try:
        yield holder
    finally:
        torch.cuda.synchronize()
        t1 = time.time_ns()
        prof.stop()
        holder.trace = _reduce(prof, t0, t1)


def _reduce(prof, t0: int, t1: int) -> Trace:
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ds, de, dn, cs, ce, cn, ct = [], [], [], [], [], [], []
    track, main = [], None
    for e in events:
        s = e.start_ns()
        d = e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", lambda: False)() or e.name() == TRACK_RANGE:
                continue  # the device-side copy of a record_function range, not device work
            ds.append(s)
            de.append(s + d)
            dn.append(e.name())
        else:
            name = e.name()
            if name == TRACK_RANGE:
                track.append((s, s + d))
                main = e.start_thread_id()
            cs.append(s)
            ce.append(s + d)
            cn.append(name)
            ct.append(e.start_thread_id())
    i64 = lambda x: np.asarray(x, np.int64)  # noqa: E731
    ds_, de_ = i64(ds), i64(de)
    keep = (de_ > t0) & (ds_ < t1)
    return Trace(
        window_s=(t1 - t0) * 1e-9,
        dev_start=np.maximum(ds_[keep], t0), dev_end=np.minimum(de_[keep], t1),
        dev_name=[n for n, k in zip(dn, keep) if k],
        track=i64(track).reshape(-1, 2), cpu_start=i64(cs), cpu_end=i64(ce), cpu_name=cn,
        cpu_thread=i64(ct), main_thread=-1 if main is None else main,
    )
