"""All rays the device frames traced (the renderer's ``rays_traced``,
after the window, the traffic's ``device_frames`` of them), in millions,
over the seconds in which an operation ran on the device in those
frames: the union of the device's operations in the trace of its
activity alone. What the card gives a second of its time; the host's
time between operations is not in it."""

from rtbench import stats


def read(run):
    if run.device_rays is None or not run.device_busy_s:
        return None
    return stats.rate(run.device_rays, run.device_busy_s) / 1e6
