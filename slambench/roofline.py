"""A kernel's share of its roofline: the least time the card could take
for one launch's work (bounds.py, counted on the reference extraction of
the checked frames), over the device time per launch that torch.profiler
measured for that kernel in the window. None when the trace saw no launch
or no frame was checked."""

from __future__ import annotations


def share(run, kernel: str, bound_of) -> float | None:
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time(kernel)
    bounds = bound_of(run)
    if launches == 0 or seconds <= 0 or not bounds:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (seconds / launches)


def extraction_gain(run) -> bool:
    return bool(run.settings.get("ORBextractor.normalizeExposure", 1.0))


def budgets(run):
    from slambench.checks import reference_extractor

    return reference_extractor(run.settings).budgets
