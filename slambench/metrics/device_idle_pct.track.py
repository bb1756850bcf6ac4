"""Device: the share of the time inside track_* calls in which nothing ran on the card (torch.profiler device activity intersected with the harness's call intervals)."""


def read(run):
    t = run.trace
    if t is None or len(t.track) == 0:
        return None
    inside = float((t.track[:, 1] - t.track[:, 0]).sum()) * 1e-9
    return 100.0 * (1.0 - t.busy_within(t.track) / inside)
