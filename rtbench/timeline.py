"""Reading a traced window: the profiler's timeline (a Chrome trace of
``torch.profiler``, activities CPU and CUDA) reduced to what the per-layer
metrics read.

The harness marks the window with its own spans (``record_function``):

- ``rtbench.frame`` around each frame, from the call of ``render_frame``
  to the ``synchronize()`` that ends it;
- ``rtbench.layer.<id>`` around each call of a layer's entry points
  (``rtbench/layers/<id>.json``);
- ``rtbench.harness`` around the harness's own work inside a frame (the
  final synchronize, copies of a layer's inputs for the roofline).

The profiler's host work on every operator stretches such a window (by
about 1.9 times in a ``pt.d2`` frame), so the device's busy and idle time
come from frames traced before, for the device's activity alone
(:func:`sync_window`), each ended in a device-wide synchronize.

Each device operation (kernel, copy, fill) is given to the frame and to
the innermost layer span in which the host launched it (the runtime
call with the operation's correlation id). Operations under
``rtbench.harness`` belong to no layer and are not counted as launches;
those under no layer span belong to the residual layer.
"""

from __future__ import annotations

import json
from collections import defaultdict

from rtbench import stats

FRAME = "rtbench.frame"
HARNESS = "rtbench.harness"
LAYER_PREFIX = "rtbench.layer."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# Runtime calls in which the host waits for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")
# The harness's own end of a frame (``torch.cuda.synchronize``).
DEVICE_SYNCS = ("cudaDeviceSynchronize", "cuCtxSynchronize")
NAME_CHARS = 120


def load(path: str) -> list:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def sync_window(events):
    """(busy seconds, window seconds) of a trace of the device's activity
    alone, read from the profiler's own events
    (``prof.profiler.kineto_results.events()``, no trace file): the
    device's operations are the events on a CUDA device; the window runs
    from the end of the first device-wide synchronize (the harness's
    marker) to the end of the last (the last frame's)."""
    from torch.autograd import DeviceType
    syncs, ops = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() in DEVICE_SYNCS:
            syncs.append(e.start_ns() + e.duration_ns())
    syncs.sort()
    if len(syncs) < 2:
        raise ValueError("the device trace holds no frame between "
                         "device-wide synchronizes")
    lo, hi = syncs[0], syncs[-1]
    return stats.union_length(ops, lo, hi) / 1e9, (hi - lo) / 1e9


def innermost(spans, queries):
    """For each query time, the innermost of the nested (start, end, name)
    ``spans`` that holds it (the latest-starting one), or None."""
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = [None] * len(queries)
    stack, i = [], 0
    for qi in order:
        q = queries[qi]
        while i < len(spans) and spans[i][0] <= q:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= q:
            stack.pop()
        out[qi] = stack[-1] if stack else None
    return out


class Timeline:
    """A traced window. Times are the trace's microseconds; the public
    readings are in milliseconds and seconds."""

    def __init__(self, events, residual: str | None = None):
        anns = [e for e in events if e.get("cat") == "user_annotation"]
        frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in anns
                        if e["name"] == FRAME)
        if not frames:
            raise ValueError("the trace holds no frame span")
        self.frames = frames
        self.n_frames = len(frames)
        self.lo, self.hi = frames[0][0], frames[-1][1]
        main = {e["tid"] for e in anns if e["name"] == FRAME}
        spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in anns
                 if e["name"] == HARNESS or e["name"].startswith(LAYER_PREFIX)]
        frame_spans = [(s, e, i) for i, (s, e) in enumerate(frames)]
        launch = {}
        runtime = []
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
                runtime.append(e)
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.device_intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
        t_launch = [launch.get(e.get("args", {}).get("correlation"),
                               e["ts"]) for e in dev]
        in_frame = innermost(frame_spans, t_launch)
        in_span = innermost(spans, t_launch)
        # (name, cat, duration us, frame or None, layer, harness)
        self.ops = []
        for e, f, s in zip(dev, in_frame, in_span):
            name = s[2] if s else None
            layer = (name[len(LAYER_PREFIX):] if name and
                     name.startswith(LAYER_PREFIX) else residual)
            self.ops.append((e["name"], e["cat"], e["dur"],
                             f[2] if f else None, layer, name == HARNESS))
        r_times = [e["ts"] for e in runtime]
        r_frame = innermost(frame_spans, r_times)
        r_span = innermost(spans, r_times)
        self.syncs = sum(1 for e, f, s in zip(runtime, r_frame, r_span)
                         if f is not None and e["name"] in SYNC_CALLS
                         and not (s and s[2] == HARNESS))
        self._host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                      if e.get("cat") in HOST_CATS and e.get("tid") in main]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return stats.union_length(self.device_intervals, self.lo,
                                  self.hi) / 1e6

    def _counted(self, frame=None):
        return [o for o in self.ops if o[3] is not None and not o[5]
                and (frame is None or o[3] == frame)]

    def layer_ms(self, layer: str, frame=None) -> float:
        """Device ms of a layer's operations: a mean over the frames, or
        in one frame."""
        total = sum(o[2] for o in self._counted(frame) if o[4] == layer)
        return total / 1e3 / (1 if frame is not None else self.n_frames)

    def has_layer(self, layer: str) -> bool:
        return any(o[4] == layer for o in self._counted())

    def launches_per_frame(self) -> float:
        return sum(1 for o in self._counted()
                   if o[1] == "kernel") / self.n_frames

    def syncs_per_frame(self) -> float:
        return self.syncs / self.n_frames

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle stretches
        of the window summed by what the host was doing in them; the
        harness's own operations and the stretches it holds the host in
        are named ``rtbench.harness``."""
        by_op = defaultdict(float)
        for name, _, dur, frame, _, harness in self.ops:
            if frame is not None:
                by_op[HARNESS if harness else name[:NAME_CHARS]] += dur / 1e6
        idle = stats.gaps(self.device_intervals, self.lo, self.hi)
        mids = [(s + e) / 2 for s, e in idle]
        harness = [(s, e, n) for s, e, n in self._host if n == HARNESS]
        by_host = defaultdict(float)
        for (s, e), h, own in zip(idle, innermost(self._host, mids),
                                  innermost(harness, mids)):
            name = (HARNESS if own else h[2][:NAME_CHARS] if h
                    else "host, outside any op")
            by_host[name] += (e - s) / 1e6
        return {"device_ops": [list(kv) for kv in sorted(
                    by_op.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [list(kv) for kv in sorted(
                    by_host.items(), key=lambda kv: -kv[1])[:top]]}
