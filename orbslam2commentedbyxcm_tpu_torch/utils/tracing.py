"""Per-frame tracing: named spans and counters, per frame, per keyframe a
worker took up, and in total.

Counterpart of orbslam2commentedbyxcm_tpu/utils/tracing.py (the reference
has only `cout` progress prints, e.g. src/LoopClosing.cc:449):

    tracer = Tracer()
    system = System(..., tracer=tracer)
    ...
    print(tracer.summary_table())
    tracer.dump_jsonl("trace.jsonl")

Each closed span leaves one record (`timeline()`): its name, its thread's
role (`tracking` for any thread but the workers, else the worker thread's
name: `local-mapping`, `loop-closing`, `global-ba`), `start_ns` / `end_ns`,
its id and its parent's (the span open around it on the same thread), and
its cause: on the thread that opened the frame, the frame id; on a worker,
the keyframe it works on and the frame whose tracking inserted it
(`worker()`, `cause()`). The stamps are `time.perf_counter_ns()` plus an
offset to `time.time_ns()` fixed when the tracer is enabled, the timebase of
torch.profiler's events; `stats()` takes its durations from them. While the
tracer is enabled each span also opens a `torch.profiler.record_function`
range under its label (at most 24 characters), so a profile names the host
time by span.

A frame record sums the spans of the thread that opened the frame; a
worker record, those of one keyframe on one worker. On a CUDA device the
host only enqueues kernels: a span that does not end in a host read of a
device result (`.cpu()`, `.item()`, a synchronize) measures the enqueue,
not the device work, and the device time surfaces in the next span that
reads. Most of the System's spans end in such a read; the ones that do not
say so where they are opened.

`TracedLock` is the System's map lock when it is given a tracer: the
holder's role, and hold time and count per role as counters. A disabled
tracer (`Tracer(enabled=False)`, or None in the System) records nothing and
costs one attribute check per span.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict

import torch

# the worker threads' names (models/async_pipeline, models/gba); every other
# thread records as "tracking"
WORKER_ROLES = frozenset({"local-mapping", "loop-closing", "global-ba"})


def thread_role() -> str:
    name = threading.current_thread().name
    return name if name in WORKER_ROLES else "tracking"


class Tracer:
    def __init__(self, enabled: bool = True):
        self._lock = threading.Lock()
        self._local = threading.local()  # per thread: the open spans, the worker record
        self._ids = itertools.count()
        self._frames: list[dict] = []
        self._workers: list[dict] = []
        self._timeline: list[dict] = []
        self._current: dict | None = None
        self._frame_thread: int | None = None
        self._spans: dict[str, list[float]] = defaultdict(list)
        self._counters: dict[str, float] = defaultdict(float)
        self.enabled = enabled

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on: bool):
        if on:
            self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self._enabled = bool(on)

    # -- frame lifecycle -----------------------------------------------------

    def begin_frame(self, frame_id, timestamp: float | None = None):
        if not self._enabled:
            return
        with self._lock:
            self._current = {"kind": "frame", "frame": frame_id, "timestamp": timestamp, "spans": {}}
            self._frame_thread = threading.get_ident()

    def end_frame(self, **fields):
        if not self._enabled:
            return
        with self._lock:
            if self._current is not None:
                self._current.update(fields)
                self._frames.append(self._current)
                self._current = None

    @contextlib.contextmanager
    def worker(self, kf_id: int, frame_id):
        """The block is this worker thread's work on keyframe `kf_id`, which
        the tracking of frame `frame_id` inserted: its spans go into one
        worker record."""
        if not self._enabled:
            yield
            return
        rec = {"kind": "worker", "role": thread_role(), "kf": kf_id, "frame": frame_id, "spans": {}}
        self._local.worker = rec
        try:
            yield
        finally:
            self._local.worker = None
            with self._lock:
                self._workers.append(rec)

    def cause(self):
        """The frame this thread works for: the open frame on its own thread,
        on a worker the frame that inserted the keyframe; else None."""
        if not self._enabled:
            return None
        cur = self._current
        if cur is not None and threading.get_ident() == self._frame_thread:
            return cur["frame"]
        w = getattr(self._local, "worker", None)
        return None if w is None else w["frame"]

    # -- spans / counters ----------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, label: str | None = None, **fields):
        """Time the block as span `name`; `label` (default `name`) names its
        profiler range, `fields` go into its record."""
        if not self._enabled:
            yield
            return
        local = self._local
        stack = local.__dict__.setdefault("stack", [])
        cur = self._current
        if cur is not None and threading.get_ident() == self._frame_thread:
            target, kf, frame = cur, None, cur["frame"]
        else:
            target = getattr(local, "worker", None)
            kf, frame = (None, None) if target is None else (target["kf"], target["frame"])
        rec = {"name": name, "role": thread_role(), "id": next(self._ids),
               "parent": stack[-1]["id"] if stack else None, "frame": frame, "kf": kf, **fields}
        stack.append(rec)
        rf = torch.profiler.record_function(label or name)
        rf.__enter__()
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            rf.__exit__(None, None, None)
            stack.pop()
            rec["start_ns"], rec["end_ns"] = t0 + self._offset_ns, t1 + self._offset_ns
            dt = (t1 - t0) * 1e-9
            with self._lock:
                self._timeline.append(rec)
                self._spans[name].append(dt)
                if target is not None:
                    sp = target["spans"]
                    sp[name] = sp.get(name, 0.0) + dt

    def count(self, name: str, value: float = 1.0):
        if not self._enabled:
            return
        with self._lock:
            self._counters[name] += value

    # -- reporting -------------------------------------------------------------

    def stats(self) -> dict:
        """{"spans": {name: {n, total_s, mean_ms, p50_ms, p95_ms}}, "counters": {...}}."""
        with self._lock:
            out: dict = {"spans": {}, "counters": dict(self._counters)}
            for name, xs in self._spans.items():
                s = sorted(xs)
                n = len(s)
                out["spans"][name] = {
                    "n": n,
                    "total_s": sum(s),
                    "mean_ms": 1e3 * sum(s) / n,
                    "p50_ms": 1e3 * s[n // 2],
                    "p95_ms": 1e3 * s[min(n - 1, int(0.95 * n))],
                }
        return out

    def summary_table(self) -> str:
        st = self.stats()
        lines = [f"{'span':<24}{'n':>6}{'mean ms':>10}{'p50 ms':>10}{'p95 ms':>10}{'total s':>10}"]
        for name, d in sorted(st["spans"].items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:<24}{d['n']:>6}{d['mean_ms']:>10.2f}{d['p50_ms']:>10.2f}"
                         f"{d['p95_ms']:>10.2f}{d['total_s']:>10.2f}")
        for name, v in sorted(st["counters"].items()):
            lines.append(f"{name:<23} {v:>6g}")  # a space after the longer names
        return "\n".join(lines)

    def frame_records(self) -> list[dict]:
        """Per-frame records ({"kind": "frame", "frame", "timestamp", "spans",
        ...}): the spans of the thread that opened the frame, seconds by name."""
        with self._lock:
            return list(self._frames)

    def worker_records(self) -> list[dict]:
        """Per-keyframe worker records ({"kind": "worker", "role", "kf",
        "frame", "spans"}), in the order the workers finished them."""
        with self._lock:
            return list(self._workers)

    def timeline(self) -> list[dict]:
        """Every span record, by start ({"name", "role", "id", "parent",
        "frame", "kf", "start_ns", "end_ns", ...})."""
        with self._lock:
            return sorted(self._timeline, key=lambda r: r["start_ns"])

    def dump_jsonl(self, path: str):
        """One JSON object per frame (spans in seconds), then one per worker
        record, then a summary row; each row has a `kind`."""
        rows = self.frame_records() + self.worker_records()
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
            f.write(json.dumps({"kind": "summary", "summary": self.stats()}) + "\n")


class TracedLock:
    """`threading.Lock` (acquire, release, the context manager, locked) that
    keeps its holder's role (`thread_role()`) and, on each release, adds the
    hold to the tracer's counters `lock_hold_s.<role>` and `lock_holds.<role>`."""

    def __init__(self, tracer: Tracer):
        self._lock = threading.Lock()
        self.tracer = tracer
        self.holder: str | None = None
        self._since_ns = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not self._lock.acquire(blocking, timeout):
            return False
        self.holder = thread_role()
        self._since_ns = time.perf_counter_ns()
        return True

    def release(self):
        held_ns = time.perf_counter_ns() - self._since_ns
        role, self.holder = self.holder, None
        self._lock.release()
        self.tracer.count(f"lock_hold_s.{role}", held_ns * 1e-9)
        self.tracer.count(f"lock_holds.{role}")

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


def span(tracer, name: str):
    """`tracer.span(name)`, or a no-op context when `tracer` is None."""
    return contextlib.nullcontext() if tracer is None else tracer.span(name)


def count(tracer, name: str, value: float = 1.0):
    """`tracer.count(name, value)` when there is a tracer."""
    if tracer is not None:
        tracer.count(name, value)


def worker(tracer, kf_id: int, frame_id):
    """`tracer.worker(kf_id, frame_id)`, or a no-op context."""
    return contextlib.nullcontext() if tracer is None else tracer.worker(kf_id, frame_id)


def cause(tracer):
    """`tracer.cause()`, or None without a tracer."""
    return None if tracer is None else tracer.cause()


def acquired(tracer, lock):
    """A context that holds `lock`. With a tracer, acquiring it is a
    `lock_wait` span whose record carries `holder`, the role that held the
    lock when the wait began, and whose profiler label is
    `lock_wait:<holder>`; without one, `lock` itself."""
    return lock if tracer is None else _acquired(tracer, lock)


@contextlib.contextmanager
def _acquired(tracer: Tracer, lock):
    holder = getattr(lock, "holder", None)
    with tracer.span("lock_wait", label=f"lock_wait:{holder or 'free'}", holder=holder):
        lock.acquire()
    try:
        yield
    finally:
        lock.release()
