"""All rays the window's frames traced (the renderer's ``rays_traced``,
shadow rays included), in millions, over the window's wall time."""

from rtbench import stats


def read(run):
    return stats.rate(run.rays, run.window_s) / 1e6
