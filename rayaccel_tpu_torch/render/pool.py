"""The frame pool: one staged bounce loop over a whole frame's lanes.

Both pooled frames (``pathtracer.pt_trace_frame`` and
``whitted.whitted_trace_frame``) pool every lane of the frame after the
primaries and run one bounce loop over the pool. :func:`run_pool` is that
loop: while lanes live it steps the pool; when the live count fits the next
width of the frame's ladder, it shrinks the pool once (live lanes move to
the head in a stable order) and leaves behind a piece of rows, the lane id
and the frame's columns of the lanes that died since the last shrink.
:func:`by_lane` puts the rows back in lane order, routed home first when a
mesh reshard moved lanes between ranks. The host reads its loop conditions
inside ``racc.render.read.*`` spans.
"""

from __future__ import annotations

import torch

from rayaccel_tpu_torch.parallel.mesh import Mesh, route_rows_home
from rayaccel_tpu_torch.utils.spans import span

# Piece rows carrying this lane value are live-lane duplicates emitted by
# the shrink; reassembly skips them.
LANE_INVALID = 3e38


def read_count(mask: torch.Tensor, site: str) -> int:
    """``int(mask.sum())``, a host wait, inside the span ``site``."""
    with span(site):
        return int(mask.sum())


def read_any(mask: torch.Tensor, site: str) -> bool:
    """``bool(mask.any())``, a host wait, inside the span ``site``."""
    with span(site):
        return bool(mask.any())


def first_lane(N: int, mesh: Mesh | None, n_shards: int) -> int:
    """This rank's first global lane id in a pool of N lanes a rank. The
    pieces carry lane ids as float32, exact only below 2^24."""
    assert N * n_shards < (1 << 24), \
        f"frame pool {N} x {n_shards} ranks >= 2^24 lanes"
    if mesh is None:
        return 0
    assert n_shards == mesh.size
    return mesh.rank * N


def _shrink(alive, lane, n_fresh: int, nxt: int, cols):
    """The width shrink of a pooled bounce loop. Returns (perm, piece):
    the first ``nxt`` positions of a stable live-first order (the new
    head), and the piece the pool leaves behind: at every position, the
    lane id and ``cols`` where the lane is fresh (below ``n_fresh``, so
    alive when the stage began) and dead now, ``LANE_INVALID`` elsewhere,
    so that each dead lane is emitted exactly once."""
    iota = torch.arange(alive.shape[0], dtype=torch.int32,
                        device=alive.device)
    perm = torch.argsort(torch.where(alive, iota, 0x7FFFFFFF),
                         stable=True)[:nxt]
    valid = (iota < n_fresh) & ~alive
    piece = torch.cat([torch.where(valid, lane.to(torch.float32),
                                   LANE_INVALID)[:, None], *cols], dim=1)
    return perm, piece


def _final_piece(lane, n_fresh: int, shrunk: bool, cols):
    """The last stage's piece. After a shrink, the rows at or past
    ``n_fresh`` are dead filler hauled into the head, emitted in an
    earlier piece: they are marked invalid."""
    final = lane.to(torch.float32)
    if shrunk:
        final = torch.where(torch.arange(final.shape[0], device=lane.device)
                            < n_fresh, final, LANE_INVALID)
    return torch.cat([final[:, None], *cols], dim=1)


def run_pool(st: dict, widths, step, narrow, cols):
    """The staged bounce loop over the pooled lane state ``st`` (a dict
    with the (N,) ``alive`` mask and int32 ``lane`` ids, N = ``widths[0]``).

    ``step(st)`` is one bounce of every lane, run while any lane lives.
    When the live count fits ``widths[i + 1]``, the pool shrinks to that
    width: ``narrow(st, perm, n_live)`` returns the state of the lanes at
    ``perm`` (live ones first, then dead filler), its first ``n_live``
    alive. ``cols(st)`` gives the (rows, k) columns a piece carries beside
    the lane id.

    The pool takes ``st`` over and empties it, so that the caller holds no
    full-width lane state once the pool has narrowed.

    Returns (state, rows, iterations): the last stage's state, every
    piece's rows (lane id as float32, then the columns) with each lane
    valid exactly once, and the number of steps taken."""
    st, taken = dict(st), st
    taken.clear()
    n_fresh = widths[0]
    pieces = []
    iterations = 0
    for nxt in [*widths[1:], None]:
        while True:
            n_live = read_count(st["alive"], "racc.render.read.pool_count")
            if n_live == 0 or (nxt is not None and n_live <= nxt):
                break
            with span("racc.render.loop"):
                st = step(st)
            iterations += 1
        if nxt is None:
            break
        with span("racc.render.shrink"):
            perm, piece = _shrink(st["alive"], st["lane"], n_fresh, nxt,
                                  cols(st))
            pieces.append(piece)
            st = narrow(st, perm, n_live)
        n_fresh = n_live
    pieces.append(_final_piece(st["lane"], n_fresh, len(widths) > 1,
                               cols(st)))
    rows = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    return st, rows, iterations


def by_lane(lane_f, rows, N: int, lane0: int = 0, mesh: Mesh | None = None,
            resharded: bool = False):
    """(N, cols): each valid row (``lane_f`` below ``LANE_INVALID``)
    scattered to its lane id, less this rank's first lane id ``lane0``.

    When the reshard fired, the rows of lanes this rank traced are routed
    first to the ranks that own them. Each lane this rank held after the
    exchange is valid exactly once, so exactly N rows are, N / D of each
    home rank: the exchange home is ``parallel/mesh.py:route_rows_home``'s.
    """
    if resharded:
        with span("racc.render.exchange"):
            valid = lane_f < LANE_INVALID
            with span("racc.render.read.route_home"):
                out = torch.cat([lane_f[valid, None], rows[valid]], dim=1)
            routed = route_rows_home(out, mesh, True)
        lane_f, rows = routed[:, 0], routed[:, 1:]
    real = lane_f < LANE_INVALID
    out = torch.zeros((N, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    with span("racc.render.read.by_lane"):
        out[lane_f[real].to(torch.int64) - lane0] = rows[real]
    return out
