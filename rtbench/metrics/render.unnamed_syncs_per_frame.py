"""Host waits a frame, counted as ``render.syncs_per_frame`` counts them
but on the main thread, that lie under none of the program's
``racc.<layer>.read.<site>`` spans: waits the program does not name."""

from rtbench import spans


def read(run):
    return spans.unnamed_syncs_per_frame(run.timeline)
