"""The share of the traced window in which no operation ran on the device:
1 - (union of device operation intervals / window), in percent, from the
trace of the device's activity alone."""


def read(run):
    return 100.0 * (1.0 - run.device_busy_s / run.device_window_s)
