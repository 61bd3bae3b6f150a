"""Reading the program's own spans in a traced window.

The program marks its frame with ``record_function`` ranges while a
profiler is on (``rayaccel_tpu_torch/utils/spans.py``): every one is
named ``racc.<layer>.<what>``, lies inside ``racc.render.frame``, and
``racc.<layer>.read.<site>`` marks a place where the host waits for the
device. These readers take them from the main thread's host events that
:class:`rtbench.timeline.Timeline` keeps.

A program that marks nothing (a version older than its spans) reads 0
in every idle and count metric, and every host wait as unnamed: each
reading holds what its definition says of such a program, and a due
metric that reads nothing is a fault to the harness (``metrics_unread``).
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

from rtbench import stats, timeline

PREFIX = "racc."
LOOP = "racc.render.loop"
SPARSE = "racc.sparse"
SPARSE_PASS = "racc.sparse.pass"
READ = ".read."


def program_spans(tl) -> list:
    """The program's (start, end, name) spans on the main thread."""
    return [h for h in tl._host if h[2].startswith(PREFIX)]


def idle_ms_by_layer(tl):
    """{layer: idle ms a frame}: the window's idle stretches (no device
    operation running) cut at every boundary of the program's spans and
    the harness's own, each piece given to the layer of the innermost
    program span over it; pieces under no program span, or under the
    harness's span, count nowhere, so a program without spans gives {}.
    None without device operations."""
    if not tl.device_intervals:
        return None
    spans = program_spans(tl)
    spans += [h for h in tl._host if h[2] == timeline.HARNESS]
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    pieces = []
    for lo, hi in stats.gaps(tl.device_intervals, tl.lo, tl.hi):
        i = bisect_right(cuts, lo)
        while i < len(cuts) and cuts[i] < hi:
            pieces.append((lo, cuts[i]))
            lo = cuts[i]
            i += 1
        pieces.append((lo, hi))
    out = defaultdict(float)
    owners = timeline.innermost(spans, [(s + e) / 2 for s, e in pieces])
    for (s, e), owner in zip(pieces, owners):
        if owner is not None and owner[2] != timeline.HARNESS:
            # The layer is the second part of the span's name.
            out[owner[2].split(".")[1]] += (e - s) / 1e3 / tl.n_frames
    return dict(out)


def idle_ms(tl, layer: str):
    """Idle ms a frame under the program spans of ``layer`` (0 where no
    span of the layer holds idle time)."""
    by_layer = idle_ms_by_layer(tl)
    return None if by_layer is None else by_layer.get(layer, 0.0)


def count(tl, name: str) -> int:
    """The program spans called ``name`` in the window."""
    return sum(1 for s in program_spans(tl) if s[2] == name)


def unnamed_syncs_per_frame(tl):
    """Host waits a frame, counted as ``Timeline.syncs`` counts them (the
    runtime's synchronizing calls inside a frame, none under the
    harness's span) but on the main thread, that lie under no
    ``racc.<layer>.read.<site>`` span."""
    frames = [(s, e, timeline.FRAME) for s, e in tl.frames]
    harness = [h for h in tl._host if h[2] == timeline.HARNESS]
    reads = [h for h in program_spans(tl) if READ in h[2]]
    waits = [h[0] for h in tl._host if h[2] in timeline.SYNC_CALLS]
    n = sum(1 for f, h, r in zip(timeline.innermost(frames, waits),
                                 timeline.innermost(harness, waits),
                                 timeline.innermost(reads, waits))
            if f is not None and h is None and r is None)
    return n / tl.n_frames
