"""The port's Tracer span `local_mapping` over the window, median (host clock inside the port)."""


def read(run):
    return run.span_p50("local_mapping")
