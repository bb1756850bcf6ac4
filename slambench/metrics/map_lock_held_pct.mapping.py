"""Mapping: the share of the traced window in which the mapping worker held the map lock: the port's Tracer counter `lock_hold_s.local-mapping` (its traced map lock adds each hold on release) over the device trace's window."""


def read(run):
    t, st = run.trace, run.tracer_stats
    if t is None or st is None:
        return None
    counters = st.get("counters", {})
    if not any(name.startswith("lock_holds.") for name in counters):
        return None  # a port without a traced map lock
    return 100.0 * counters.get("lock_hold_s.local-mapping", 0.0) / t.window_s
