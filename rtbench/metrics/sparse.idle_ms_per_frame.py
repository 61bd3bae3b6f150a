"""Device idle milliseconds a frame that the program's sparse engine spans
hold (``racc.sparse*``: the passes, their pair arrays and host reads),
read as ``render.idle_ms_per_frame`` reads the renderer's
(``rtbench/spans.py``)."""

from rtbench import spans


def read(run):
    return spans.idle_ms(run.timeline, "sparse")
