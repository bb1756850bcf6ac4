"""The port's Tracer span `extract` over the window, median (host clock inside the port)."""


def read(run):
    return run.span_p50("extract")
