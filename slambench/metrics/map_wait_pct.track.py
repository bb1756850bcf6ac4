"""System: the share of the time inside track_* calls in which the tracking thread waited for the mapping side: the port's Tracer spans `handoff_wait` (the keyframe hand-off) and `lock_wait` (the map lock) over the traced window, against the harness's call intervals in the device trace."""

WAITS = ("handoff_wait", "lock_wait")


def read(run):
    t, st = run.trace, run.tracer_stats
    if t is None or st is None or len(t.track) == 0:
        return None
    spans = st.get("spans", {})
    if not any(name in spans for name in WAITS):
        return None  # a port without these spans
    waited = sum(spans[name]["total_s"] for name in WAITS if name in spans)
    inside = float((t.track[:, 1] - t.track[:, 0]).sum()) * 1e-9
    return 100.0 * waited / inside
