"""Passes a call of the sparse engine (``racc.sparse.pass`` spans over
``racc.sparse`` spans in the traced frames): 1 where no ray restarts;
each restart pass is the engine's retried work; 0 where the program marks
no call."""

from rtbench import spans


def read(run):
    calls = spans.count(run.timeline, spans.SPARSE)
    if not calls:
        return 0.0
    return spans.count(run.timeline, spans.SPARSE_PASS) / calls
