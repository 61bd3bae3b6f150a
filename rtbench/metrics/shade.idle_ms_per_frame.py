"""Device idle milliseconds a frame that the program's shading spans hold
(``racc.shade*``: the step after a trace, the surface, the BSDF, the
threefry draws, the environment), read as ``render.idle_ms_per_frame``
reads the renderer's (``rtbench/spans.py``)."""

from rtbench import spans


def read(run):
    return spans.idle_ms(run.timeline, "shade")
