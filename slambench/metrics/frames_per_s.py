"""Frames whose call returned per second: every frame sent in the window
over the time from the window's start to the last one's return (harness
clock). Flat out, the rate the system sustains."""


def read(run):
    return run.record.frames_per_s()
