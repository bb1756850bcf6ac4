"""System: call start to return of each track_* call in the untraced window, 95th percentile (harness clock): the frames that wait for the map lock or stall on a keyframe."""

from slambench.pacing import percentile


def read(run):
    return percentile(run.record.service_ms(), 95)
