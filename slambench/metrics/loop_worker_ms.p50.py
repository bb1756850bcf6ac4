"""Loop closing: the port's Tracer span `loop_worker` (one keyframe through the async loop-closing worker: BoW transform, detection, Sim3, correction) over the window, median (host clock inside the port)."""


def read(run):
    return run.span_p50("loop_worker")
