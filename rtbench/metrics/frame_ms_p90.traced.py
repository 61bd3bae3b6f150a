"""The 90th percentile of the window's frame times (host clock, from the
call of ``render_frame`` to the ``synchronize()`` that ends the frame),
read in a traced run, whose window runs untraced before the profiler
starts. A per-layer metric: its run-to-run spread is too wide for a
bound."""

from rtbench import stats


def read(run):
    return stats.percentile(run.frame_ms, 90)
