"""The layer's least time for its function's work in the captured frame
(``rtbench/work.py``: operations over the float32 peak or bytes over the
bandwidth, whichever is larger) over its device time in that frame, in
percent."""

from rtbench import work


def read(run):
    w = run.work("sparse")
    if w is None:
        return None
    ms = run.timeline.layer_ms("sparse", frame=run.captured_frame)
    if ms <= 0:
        return None
    return 100.0 * work.bound_ms(*w) / ms
