"""Device idle milliseconds a frame that the program's dense engine spans
hold (``racc.dense*``: the cull, the K1 and K4 launches, the winner
reconstruction), read as ``render.idle_ms_per_frame`` reads the
renderer's (``rtbench/spans.py``)."""

from rtbench import spans


def read(run):
    return spans.idle_ms(run.timeline, "dense")
