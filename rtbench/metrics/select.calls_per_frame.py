"""Calls of the sparse engine's select step a frame (``racc.sparse.select``
spans, one around each launch of K2 or of its plain version, in the traced
frames); 0 where the program marks no such call."""

from rtbench import spans


def read(run):
    calls = spans.count(run.timeline, "racc.sparse.select")
    return calls / run.timeline.n_frames
