"""System: call start to return of each track_* call in the untraced window, median (harness clock)."""

from slambench.pacing import percentile


def read(run):
    return percentile(run.record.service_ms(), 50)
