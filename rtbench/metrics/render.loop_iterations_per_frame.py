"""Iterations a frame of the program's frame loops: the ``racc.render.loop``
spans (one a step of a pooled bounce loop, or of a wave's loop on the
per-wave path) in the traced frames."""

from rtbench import spans


def read(run):
    tl = run.timeline
    return spans.count(tl, spans.LOOP) / tl.n_frames
