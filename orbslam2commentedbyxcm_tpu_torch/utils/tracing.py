"""Per-frame tracing: named spans and counters, per frame and in total.

Counterpart of orbslam2commentedbyxcm_tpu/utils/tracing.py (the reference
has only `cout` progress prints, e.g. src/LoopClosing.cc:449):

    tracer = Tracer()
    system = System(..., tracer=tracer)
    ...
    print(tracer.summary_table())
    tracer.dump_jsonl("trace.jsonl")

Spans are host wall-clock seconds (time.perf_counter), as in the JAX package.
On a CUDA device the host only enqueues kernels: a span that does not end in
a host read of a device result (`.cpu()`, `.item()`, a synchronize) measures
the enqueue, not the device work, and the device time surfaces in the next
span that reads. Most of the System's spans end in such a read; the ones
that do not say so where they are opened.

Thread-safe: the async mapping and loop-closing workers record into the same
tracer as the tracking thread (their spans land in whichever frame is open).
A disabled tracer (`Tracer(enabled=False)`, or None in the System) costs one
attribute check per span.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._frames: list[dict] = []
        self._current: dict | None = None
        self._spans: dict[str, list[float]] = defaultdict(list)
        self._counters: dict[str, float] = defaultdict(float)

    # -- frame lifecycle -----------------------------------------------------

    def begin_frame(self, frame_id, timestamp: float | None = None):
        if not self.enabled:
            return
        with self._lock:
            self._current = {"frame": frame_id, "timestamp": timestamp, "spans": {}}

    def end_frame(self, **fields):
        if not self.enabled:
            return
        with self._lock:
            if self._current is not None:
                self._current.update(fields)
                self._frames.append(self._current)
                self._current = None

    # -- spans / counters ----------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._spans[name].append(dt)
                if self._current is not None:
                    sp = self._current["spans"]
                    sp[name] = sp.get(name, 0.0) + dt

    def count(self, name: str, value: float = 1.0):
        if not self.enabled:
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
            lines.append(f"{name:<24}{v:>6g}")
        return "\n".join(lines)

    def frame_records(self) -> list[dict]:
        """Per-frame records ({"frame", "timestamp", "spans", ...})."""
        with self._lock:
            return list(self._frames)

    def dump_jsonl(self, path: str):
        """One JSON object per frame (spans in seconds), then a summary row."""
        frames = self.frame_records()
        with open(path, "w") as f:
            for fr in frames:
                f.write(json.dumps(fr) + "\n")
            f.write(json.dumps({"summary": self.stats()}) + "\n")


def span(tracer, name: str):
    """`tracer.span(name)`, or a no-op context when `tracer` is None."""
    return contextlib.nullcontext() if tracer is None else tracer.span(name)
