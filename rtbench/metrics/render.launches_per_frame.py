"""Kernel launches a frame in the trace, the harness's own left out."""


def read(run):
    return run.timeline.launches_per_frame()
