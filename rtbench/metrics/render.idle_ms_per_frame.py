"""Device idle milliseconds a frame that the program's renderer spans
hold (``racc.render.*``: the frame's own Python, stage 1, the loops, the
shrink, the assembly, their host reads), in the traced frames: each idle
stretch is cut at the program's span boundaries and every piece goes to
the layer of the innermost span over it (``rtbench/spans.py``). The
profiler's host work stretches the traced frames, so it reads high."""

from rtbench import spans


def read(run):
    return spans.idle_ms(run.timeline, "render")
