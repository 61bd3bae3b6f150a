"""``mrays_per_s`` of a traced run, whose window runs untraced before the
profiler starts: all rays the window's frames traced over the window's
wall time. A per-layer metric in the cells where the host paces the
frame: there its run-to-run spread is too wide for a bound."""

from rtbench import stats


def read(run):
    return stats.rate(run.rays, run.window_s) / 1e6
