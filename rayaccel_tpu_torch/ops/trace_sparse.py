"""Pair-centric sparse tracer — the bounce-ray engine.

Counterpart of ``rayaccel_tpu/ops/trace_sparse.py``. Each (ray, cluster)
overlap pair is one lane of a flat work array, so the work follows the
per-ray overlap instead of a tile's union:

1. the fused cull + nearest-k select, kernel K2 (``csrc/select_nearest.cu``,
   replacing ``_select_kernel``), picks each ray's k nearest clusters past
   its restart window and reports the (k+1)-th as the spill word;
2. the (cluster, ray, rank) lattice is sorted as one int64 word per pair,
   truncated to the pair budget (counted), and each pair's feature row is
   rebuilt from its ray;
3. the pair kernel K3 (``csrc/pair_hit.cu``, replacing ``_kernel``) tests
   each run of same-cluster pairs against its cluster;
4. a scatter-min merges packed (score | rank | column) words per ray, and
   the winner's slot is decoded through the lattice rank.

``trace_sparse`` restarts unresolved rays (whose spill entry lies before
their current best) on the compacted set until ``max_passes``, and counts
what is left, exactly as the JAX function does. ``trace_occlusion_sparse``
(``:577-698``) is its any-hit form: K3 with the exact tmax guard, no
t-shrink on restarts, and the occlusion OR-merged across passes.

The JAX wrappers dispatched over static capacity ladders (pair buckets,
item buckets, live-tile buckets) because a Pallas grid is static. Here a
pass reads its pair and item counts on the host (one sync each) and sizes
its pair arrays to them; the caps that truncate, and so the overflow
counts, are the JAX package's. Restart widths keep the JAX ladder, whose
top bucket bounds how many rays one pass takes, so the kernels meet
launches from 1,024 lanes to the whole pool. Both size themselves to the
launch inside their launchers: K2 splits a lane's boxes across 1-32
threads by the launch width and answers dead lanes without testing them;
K3 cuts the runs into work units of 64 pairs and spreads them over a grid
the size of the card.

``precision`` reaches K3 alone (K2 has no product), as in
``ops/trace_dense.py``: "default" is the one-pass bf16 product, on the
card K3's bf16 tensor-core variant on the scene's bf16 fragment copy
(``ClusterScene.G3b``).
"""

from __future__ import annotations

import torch

from rayaccel_tpu_torch.ops import _kernels
from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
from rayaccel_tpu_torch.ops.trace_dense import (fragment_copy, make_hits,
                                                reconstruct, round_bf16,
                                                use_bf16)
from rayaccel_tpu_torch.ops.trace_mxu import MxuHits
from rayaccel_tpu_torch.scene.clusters import ClusterScene
from rayaccel_tpu_torch.types import Rays
from rayaccel_tpu_torch.utils.spans import span

_RANK_SHIFT = 20          # rank rides above the cluster id in lane words
_CL_MASK = (1 << _RANK_SHIFT) - 1
_MISS_BITS = 0x7F000000   # packed-score miss marker (huge positive float)
_INF_PACK = 0x7F800000    # +inf bits: packed-entry invalid threshold
_NONE = 0x7FFFFFFF        # "no candidate" word of the select kernel
_INT_MIN = -0x80000000


# ---------------------------------------------------------------- K2 ----

def select_nearest(F8, prev, live, bb, k: int, id_bits: int, *,
                   tested=None, chunk_boxes=None,
                   count: bool = True) -> torch.Tensor:
    """K2: fused cull + nearest-k select.

    F8 (R, 8) float32 rows [o, inv_d, tmin, tmax_eff]; prev (R,) int32
    previous spill words (candidates whose packed word is below are
    excluded); live (R,) uint8, 0 for lanes of a ray tile with no live ray;
    bb (n_cp, 6) cluster boxes [bbmin | bbmax], n_cp at most 2^20 (the
    lane word's cluster field) and 2^id_bits. Returns (k + 2, R) int32:
    rows 0..k-1 the k smallest packed (entry bits | cluster id) words in
    order, row k the (k+1)-th (the spill word), row k+1 the number of
    overlapped clusters; without ``count`` the first k + 1 rows alone.
    Dead lanes get 0x7FFFFFFF words and count 0.

    On a CUDA tensor this launches ``csrc/select_nearest.cu``, whose
    launcher picks from R how many threads share a lane's boxes
    (:func:`select_split`). Past one CTA's shared memory of boxes it
    streams them in chunks of 2,048 (the kernel's ``kChunk``), skipping
    for a lane the chunks whose union box (``chunk_boxes``, the scene's
    ``bb_chunks``, which such a launch needs) cannot change its answer,
    and more of them without ``count``. ``tested`` (optional, a (1,) int64 CUDA tensor)
    gains, for each lane that ran the box loop, the chunks it tested: one
    each on the single-chunk path (the other lanes are lanes of dead tiles,
    or dead lanes answered by :func:`dead_lane_words`). On a CPU tensor it
    runs :func:`select_nearest_plain`."""
    if F8.device.type == "cpu":
        return select_nearest_plain(F8, prev, live, bb, k, id_bits,
                                    count=count)
    return _launch_select(F8, prev, live, bb, k, id_bits, 0, tested,
                          chunk_boxes, count)


select_nearest.launches = 0


def _launch_select(F8, prev, live, bb, k: int, id_bits: int, split: int,
                   tested, chunk_boxes=None, count: bool = True):
    """Validate K2's arguments and launch it. ``split`` 0 leaves the split
    to the launcher, as every caller of the package does; the card tests
    force each power of two up to 32 to hold it against the plain
    version."""
    R = F8.shape[0]
    n_cp = bb.shape[0]
    _kernels.require(F8, "F8", torch.float32, (R, 8))
    _kernels.require(prev, "prev", torch.int32, (R,))
    _kernels.require(live, "live", torch.uint8, (R,))
    _kernels.require(bb, "bb", torch.float32, (n_cp, 6))
    if tested is not None:
        _kernels.require(tested, "tested", torch.int64, (1,))
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in [1, 8], got {k}")
    if split not in (0, 1, 2, 4, 8, 16, 32):
        raise ValueError(f"split must be a power of two up to 32, got {split}")
    lib = _kernels.library()
    most = lib.racc_select_max_boxes()
    if not 1 <= n_cp <= most:
        raise ValueError(
            f"bb holds {n_cp} boxes; the select kernel takes 1 to {most} "
            f"(the lane word carries the cluster in {_RANK_SHIFT} bits)")
    if not 1 <= id_bits <= 22 or n_cp > 1 << id_bits:
        raise ValueError(f"id_bits {id_bits} must be in [1, 22] and hold "
                         f"the {n_cp} box ids")
    n_chunks = lib.racc_select_chunks(n_cp)
    if n_chunks:
        if chunk_boxes is None:
            raise ValueError(
                f"{n_cp} boxes take the select kernel's chunked path, which "
                f"needs each chunk's union box (ClusterScene.bb_chunks)")
        _kernels.require(chunk_boxes, "chunk_boxes", torch.float32,
                         (n_chunks, 6))
    out = torch.empty((k + 2, R), dtype=torch.int32, device=F8.device)
    _kernels.check(lib.racc_select_nearest(
        _kernels.ptr(F8), _kernels.ptr(prev), _kernels.ptr(live),
        _kernels.ptr(bb), _kernels.ptr(chunk_boxes) if n_chunks else None,
        _kernels.ptr(out),
        None if tested is None else _kernels.ptr(tested), R, n_cp, id_bits,
        k, split, int(count), _kernels.stream()),
        "racc_select_nearest")
    select_nearest.launches += 1
    return out if count else out[:k + 1]


def select_split(R: int) -> int:
    """The threads that share a lane's boxes in a K2 launch of R lanes, as
    the kernel's launcher picks them (from R and the card alone)."""
    return int(_kernels.library().racc_select_split(R))


def _packed_entries(f, prev, bb, id_bits: int):
    """(n, n_cp) int32: every box's packed (entry bits | box id) word for
    the rays ``f`` (rows of F8), 0x7FFFFFFF where below ``prev``."""
    n_cp = bb.shape[0]
    low = (1 << id_bits) - 1
    ids = torch.arange(n_cp, dtype=torch.int32, device=f.device)
    t0 = f[:, 6:7].expand(-1, n_cp)
    t1 = f[:, 7:8].expand(-1, n_cp)
    for a in range(3):
        tn = (bb[None, :, a] - f[:, a:a + 1]) * f[:, 3 + a:4 + a]
        tf = (bb[None, :, 3 + a] - f[:, a:a + 1]) * f[:, 3 + a:4 + a]
        t0 = torch.maximum(t0, torch.minimum(tn, tf))
        t1 = torch.minimum(t1, torch.maximum(tn, tf))
    # "+ 0.0" turns a -0.0 entry into +0.0, as the kernel does.
    e = torch.where(t0 <= t1, torch.clamp_min(t0, 0.0) + 0.0,
                    torch.full_like(t0, float("inf")))
    ep = (e.view(torch.int32) & ~low) | ids
    return torch.where(ep >= prev[:, None], ep, torch.full_like(ep, _NONE))


def _smallest(words, n: int):
    """The n smallest of each row of ``words`` in order, 0x7FFFFFFF where a
    row has fewer."""
    short = n - words.shape[1]
    if short > 0:
        words = torch.nn.functional.pad(words, (0, short), value=_NONE)
    return torch.topk(words, n, dim=1, largest=False, sorted=True).values


def select_nearest_plain(F8, prev, live, bb, k: int, id_bits: int,
                         chunk: int = 32768, split: int = 1,
                         count: bool = True) -> torch.Tensor:
    """Plain torch version of K2, over chunks of rays (an (R, n_cp) entry
    matrix at frame width would be gigabytes). ``split`` is the kernel's
    box split: part s of ``split`` takes boxes s, s + split, ..., keeps its
    own k + 1 smallest words and its count, and the parts are merged. It
    never changes the answer (the words are distinct), which
    tests/test_torch_split.py holds. Without ``count`` the count row is
    left out, as the kernel leaves it."""
    R = F8.shape[0]
    out = torch.empty((k + 2, R), dtype=torch.int32, device=F8.device)
    for s in range(0, R, chunk):
        ep = _packed_entries(F8[s:s + chunk], prev[s:s + chunk], bb, id_bits)
        parts = [ep[:, p::split] for p in range(split)]
        cnt = sum((part < _INF_PACK).sum(dim=1) for part in parts)
        top = _smallest(torch.cat([_smallest(part, k + 1) for part in parts],
                                  dim=1) if split > 1 else ep, k + 1)
        dead = live[s:s + chunk] == 0
        top[dead] = _NONE
        cnt[dead] = 0
        out[:k + 1, s:s + chunk] = top.T
        out[k + 1, s:s + chunk] = cnt.to(torch.int32)
    return out if count else out[:k + 1]


def chunk_skips(F8, prev, chunk_boxes, id_bits: int):
    """How K2's multi-chunk path may skip chunks, for each (lane, chunk):
    (skip (R, n_chunks) bool, first (R, n_chunks) int32). ``skip`` where
    the lane's window misses the chunk's union box (a row of
    ``chunk_boxes``) or the highest word a box of it could pack lies below
    the lane's ``prev``: no box of the chunk is then counted or kept.
    ``first`` is the least word a box of the chunk could pack: without the
    count, a lane skips the chunk too where ``first`` lies above its
    (k+1)-th word so far. Neither where a term could be a NaN: a lane
    whose origin or inverse direction holds a value that is not finite, or
    a zero, or whose union window is a NaN."""
    o, inv, tmin, tmax = F8[:, :3], F8[:, 3:6], F8[:, 6], F8[:, 7]
    low = (1 << id_bits) - 1
    neg = torch.signbit(inv)
    lo, hi = chunk_boxes[None, :, :3], chunk_boxes[None, :, 3:]
    near = torch.where(neg[:, None], hi, lo)
    far = torch.where(neg[:, None], lo, hi)
    t0 = tmin[:, None].expand(-1, chunk_boxes.shape[0])
    t1 = tmax[:, None].expand(-1, chunk_boxes.shape[0])
    for a in range(3):
        # fmax and fmin, as the kernel's fmaxf and fminf: a NaN operand
        # gives the other one.
        t0 = torch.fmax(t0, (near[..., a] - o[:, None, a]) * inv[:, None, a])
        t1 = torch.fmin(t1, (far[..., a] - o[:, None, a]) * inv[:, None, a])

    def word(t):
        return (torch.clamp_min(t, 0.0) + 0.0).view(torch.int32) & ~low

    sure = (torch.isfinite(o) & torch.isfinite(inv) & (inv != 0)).all(dim=1)
    sure = sure[:, None] & ~t0.isnan() & ~t1.isnan()
    skip = sure & ((t0 > t1) | ((word(t1) | low) < prev[:, None]))
    return skip, torch.where(sure, word(t0), _INT_MIN)


def select_chunks_needed(F8, prev, live, chunk_boxes, id_bits: int) -> int:
    """The (lane, chunk) pairs that K2's multi-chunk path tests when asked
    for the count, which its ``tested`` counter reads: for each lane that
    runs the box loop (of a live tile, tmax_eff not below tmin), the chunks
    that :func:`chunk_skips` does not skip."""
    skip, _ = chunk_skips(F8, prev, chunk_boxes, id_bits)
    runs = (live == 1) & ~(F8[:, 7] < F8[:, 6])
    return int((~skip)[runs].sum())


def dead_lane_words(prev, n_cp: int, k: int) -> torch.Tensor:
    """(k + 2, n) int32: K2's answer for dead lanes of a live tile, in the
    closed form the kernel writes without testing a box. A lane whose
    window is empty (tmax_eff < tmin, neither a NaN) overlaps nothing, so
    box c's word is 0x7F800000 | c, dropped when below ``prev``; the k + 1
    smallest are the boxes from max(0, prev - 0x7F800000) on, 0x7FFFFFFF
    past the last box, and the count is 0."""
    first = torch.clamp_min(prev.to(torch.int64) - _INF_PACK, 0)
    c = first[None, :] + torch.arange(k + 1, device=prev.device)[:, None]
    words = torch.where(c < n_cp, c | _INF_PACK, _NONE).to(torch.int32)
    return torch.cat([words, torch.zeros_like(words[:1])])


def _select_tile(R: int, n_cp: int) -> int:
    """The JAX wrapper's select ray tile: the unit of its dead-tile skip."""
    sel_tile = 1024
    while sel_tile * n_cp * 4 > (4 << 20) or R % sel_tile:
        sel_tile //= 2
        if sel_tile < 8:
            raise ValueError(f"wave size {R} has no usable select tile")
    return sel_tile


def _select_args(cs: ClusterScene, o, inv_d, tmin, tmax_eff,
                 prev_packed=None):
    """K2's lane arguments for the rays, as the JAX wrapper builds them:
    (F8, prev, live, id_bits)."""
    R = o.shape[0]
    n_cp = cs.bb.shape[0]
    sel_tile = _select_tile(R, n_cp)
    live = ((tmax_eff > 0).reshape(-1, sel_tile).any(dim=1)
            .repeat_interleave(sel_tile).to(torch.uint8))
    if prev_packed is None:
        prev_packed = torch.full((R,), _INT_MIN, dtype=torch.int32,
                                 device=o.device)
    F8 = torch.cat([o, inv_d, tmin[:, None], tmax_eff[:, None]], dim=1)
    return (F8, prev_packed.contiguous(), live,
            max((n_cp - 1).bit_length(), 1))


def _select(cs: ClusterScene, o, inv_d, tmin, tmax_eff, k: int,
            prev_packed=None):
    """Run K2 over the rays (the counterpart of ``_select_nearest_pallas``),
    without the count of overlapped clusters, which no caller reads.
    Returns (lat_valid (k, R) bool, lat_id (k, R) int32 nearest first,
    spill (R,) int32)."""
    F8, prev, live, id_bits = _select_args(cs, o, inv_d, tmin, tmax_eff,
                                           prev_packed)
    with span("racc.sparse.select"):
        out = select_nearest(F8, prev, live, cs.bb, k, id_bits,
                             chunk_boxes=cs.bb_chunks, count=False)
    packed = out[:k]
    return packed < _INF_PACK, packed & ((1 << id_bits) - 1), out[k]


# ---------------------------------------------------------------- K3 ----

def pair_hit(Fp, G3, items, col_bits: int, guard_tmax: bool, *,
             stats=None, precision: str = "highest", G3b=None) -> torch.Tensor:
    """K3: the pair kernel.

    Fp (P, 16) float32 pair rows [d, o, d x o, 1, tmin, tmax, lane word,
    0...], the lane word (cluster | rank << 20) as raw int32 bits; G3
    (n_c, 4C, 16); items (n_items, 3) int32 [start, end, cluster], each a
    run of pairs of one cluster inside one SP-pair block. Returns (P,)
    int32: for each pair that an item covers and whose lane word names the
    item's cluster, min(miss marker, packed (score | rank | column)); the
    miss marker 0x7F000000 elsewhere. ``guard_tmax`` adds the exact
    t < tmax test (the any-hit form).

    On a CUDA tensor this launches ``csrc/pair_hit.cu``: a one-CTA pass
    cuts the runs into work units of 64 pairs, and a grid the size of the
    card shares the units out, each CTA staging a cluster once for the
    consecutive units that name it. Nothing is read on the host.
    ``stats`` (optional, a (3,) int64 CUDA tensor) gains the work units,
    the CTAs that took any and the clusters staged. At
    ``precision="default"`` it launches the bf16 tensor-core variant,
    which reads ``G3b`` (the scene's ``ClusterScene.G3b``, required there).
    On a CPU tensor it runs :func:`pair_hit_plain`, which needs no
    ``G3b``. ``pair_hit.guard_launches`` counts the launches with
    ``guard_tmax`` (the any-hit form) and ``pair_hit.launches_bf16`` the
    bf16 ones among ``pair_hit.launches``."""
    bf16 = use_bf16(precision)
    if Fp.device.type == "cpu":
        return pair_hit_plain(Fp, G3, items, col_bits, guard_tmax,
                              precision=precision)
    P = Fp.shape[0]
    n_items = items.shape[0]
    _kernels.require(Fp, "Fp", torch.float32, (P, 16))
    _kernels.require(G3, "G3", torch.float32)
    if G3.dim() != 3 or G3.shape[1] % 4 or G3.shape[2] != 16:
        raise ValueError(f"G3 must have shape (n_c, 4C, 16), got "
                         f"{tuple(G3.shape)}")
    n_c, C = G3.shape[0], G3.shape[1] // 4
    G3b = fragment_copy(G3b, n_c, C, precision)
    _kernels.require(items, "items", torch.int32, (n_items, 3))
    if stats is not None:
        _kernels.require(stats, "stats", torch.int64, (3,))
    out = torch.full((P,), _MISS_BITS, dtype=torch.int32, device=Fp.device)
    if n_items == 0 or P == 0:
        return out
    unit_start = torch.empty(n_items + 1, dtype=torch.int32, device=Fp.device)
    lib = _kernels.library()
    _kernels.check(lib.racc_pair_hit(
        _kernels.ptr(Fp), _kernels.ptr(G3),
        None if G3b is None else _kernels.ptr(G3b), _kernels.ptr(items),
        _kernels.ptr(unit_start), n_items, _kernels.ptr(out),
        None if stats is None else _kernels.ptr(stats), P, n_c, C, col_bits,
        int(guard_tmax), _kernels.stream()), "racc_pair_hit")
    pair_hit.launches += 1
    pair_hit.guard_launches += bool(guard_tmax)
    pair_hit.launches_bf16 += bf16
    return out


pair_hit.launches = 0
pair_hit.guard_launches = 0
pair_hit.launches_bf16 = 0


def pair_hit_plain(Fp, G3, items, col_bits: int, guard_tmax: bool,
                   chunk: int = 4096, col_split: int = 1,
                   precision: str = "highest") -> torch.Tensor:
    """Plain torch version of K3, over chunks of covered pairs. The
    bilinear products are summed feature by feature with elementwise
    operations, so a pair's result does not depend on where it sits in the
    array. ``col_split`` is the kernel's column split: part s takes columns
    s, s + col_split, ... and the parts' packed minima are merged; it never
    changes the answer (tests/test_torch_split.py). At
    ``precision="default"`` the features (columns 0-9 of a pair row, and
    G3) are rounded to bf16 before the products; tmin and tmax are not."""
    bf16 = use_bf16(precision)
    P = Fp.shape[0]
    out = torch.full((P,), _MISS_BITS, dtype=torch.int32, device=Fp.device)
    if items.shape[0] == 0:
        return out
    covered, cl = covered_pairs(Fp, items)
    sel = covered.nonzero().squeeze(1)
    lanes = Fp[:, 12].contiguous().view(torch.int32)
    G10 = round_bf16(G3[:, :, :10]) if bf16 else G3[:, :, :10]
    for s in range(0, sel.numel(), chunk):
        q = sel[s:s + chunk]
        out[q] = pair_words(Fp[q], G10[cl[q]], lanes[q], col_bits,
                            guard_tmax, col_split, bf16)
    return out


def covered_pairs(Fp, items):
    """(covered (P,) bool, cluster (P,) int64): the pairs of ``Fp`` that an
    item covers and whose lane word names the item's cluster (the pairs
    K3 writes), and the cluster of the item at or before each pair.
    ``items`` sorted by start, at least one."""
    P = Fp.shape[0]
    starts, ends, clusters = (items[:, i].long().contiguous() for i in range(3))
    pos = torch.arange(P, device=Fp.device)
    item = torch.clamp_min(torch.searchsorted(starts, pos, right=True) - 1, 0)
    lanes = Fp[:, 12].contiguous().view(torch.int32)
    cl = clusters[item]
    return ((pos >= starts[item]) & (pos < ends[item])
            & ((lanes & _CL_MASK) == cl)), cl


def pair_words(f, g, lanes, col_bits: int, guard_tmax: bool,
               col_split: int = 1, bf16: bool = False) -> torch.Tensor:
    """K3's arithmetic for pair rows ``f`` (n, 16) against their clusters'
    columns ``g`` ((n, 4C, 10), or (1, 4C, 10) for one cluster; already
    bf16-rounded with ``bf16``), with the pairs' lane words ``lanes``
    (n,): each pair's min(miss marker, packed (score | rank | column))."""
    C = g.shape[1] // 4
    low = (1 << (col_bits + 3)) - 1
    col = torch.arange(C, dtype=torch.int32, device=f.device)
    fx = round_bf16(f[:, :10]) if bf16 else f
    S = fx[:, 0:1] * g[:, :, 0]
    for i in range(1, 10):
        S = S + fx[:, i:i + 1] * g[:, :, i]
    det, u, v, tn = S[:, :C], S[:, C:2 * C], S[:, 2 * C:3 * C], S[:, 3 * C:]
    det_i = det.view(torch.int32)
    sign_ok = ((u.view(torch.int32) ^ det_i)
               | (v.view(torch.int32) ^ det_i)) >= 0
    ad = torch.abs(det)
    ts = (tn.view(torch.int32) ^ (det_i & _INT_MIN)).view(torch.float32)
    valid = (sign_ok & (torch.abs(u + v) <= ad)
             & (ts > ad * f[:, 10:11]))
    if guard_tmax:
        valid = valid & (ts < ad * f[:, 11:12])
    score = torch.where(valid, ts * torch.reciprocal(ad),
                        torch.full_like(ts, 3e38))
    rank = (lanes >> _RANK_SHIFT) << col_bits
    sp = (score.view(torch.int32) & ~low) | rank[:, None] | col
    parts = torch.stack([sp[:, p::col_split].amin(dim=1)
                         for p in range(col_split)])
    return torch.clamp_max(parts.amin(dim=0), _MISS_BITS)


# -------------------------------------------------------- pass + trace ----

def _lattice_pairs(lat_valid, lat_id, cap: int):
    """Sort the valid (cluster, ray, rank) lattice entries as one int64
    word each and keep the first ``cap``. Returns (cl, ray, rank) int64 of
    the kept pairs and the number of valid entries."""
    K, R = lat_id.shape
    ray_bits = max((R - 1).bit_length(), 1)
    rank_bits = (K - 1).bit_length()
    ray = torch.arange(R, dtype=torch.int64, device=lat_id.device)
    rank = torch.arange(K, dtype=torch.int64, device=lat_id.device)
    with span("racc.sparse.read.lattice"):
        word = ((lat_id.to(torch.int64) << (ray_bits + rank_bits))
                | (ray[None, :] << rank_bits) | rank[:, None])[lat_valid]
    total = word.numel()
    word = torch.sort(word).values[:cap]
    return (word >> (ray_bits + rank_bits), (word >> rank_bits) & ((1 << ray_bits) - 1),
            word & ((1 << rank_bits) - 1), total)


def _pair_inputs(o, d, tlo, tmax_p, cl, ray, rank, SP: int):
    """Pair feature rows (the F-row rebuild: [d, o, d x o, 1, tlo, tmax,
    lane word]) and the work items (one per cluster run per SP block)."""
    P = cl.shape[0]
    rd, ro = d[ray], o[ray]
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    ox, oy, oz = ro[:, 0], ro[:, 1], ro[:, 2]
    lanes = (cl | (rank << _RANK_SHIFT)).to(torch.int32)
    zero = torch.zeros_like(dx)
    Fp = torch.stack([
        dx, dy, dz, ox, oy, oz,
        dy * oz - dz * oy, dz * ox - dx * oz, dx * oy - dy * ox,
        torch.ones_like(dx), tlo[ray], tmax_p[ray], lanes.view(torch.float32),
        zero, zero, zero], dim=1)
    pos = torch.arange(P, device=cl.device)
    boundary = (pos % SP == 0)
    boundary[1:] |= cl[1:] != cl[:-1]
    with span("racc.sparse.read.runs"):
        starts = boundary.nonzero().squeeze(1)
        ends = torch.cat([starts[1:], starts.new_tensor([P])])
    items = torch.stack([starts, ends, cl[starts]], dim=1).to(torch.int32)
    return Fp, items.contiguous()


def _sparse_pass(cs: ClusterScene, o, d, inv_d, tlo, tmax_p, K: int, SP: int,
                 pair_budget: int, prev_packed=None, guard_tmax: bool = True,
                 precision: str = "highest"):
    """One spill-window pass at width R = len(tlo). Returns (best_p (R,)
    int32 packed, slot_p (R,) int32, spill (R,) int32, trunc int).

    The pair and item counts are read on the host (one sync each) and size
    the pair arrays and K3's grid; the pair cap is the JAX package's top
    bucket, so truncation is counted as there."""
    with span("racc.sparse.pass"):
        R = tlo.shape[0]
        C = cs.cluster_size
        n_c = cs.n_clusters
        col_bits = max((C - 1).bit_length(), 1)
        K = min(K, n_c)
        kr_pad = -(-K * R // SP) * SP
        cap = min(max(SP, -(-pair_budget * R // SP) * SP), kr_pad)

        lat_valid, lat_id, spill = _select(cs, o, inv_d, tlo, tmax_p, K,
                                           prev_packed)
        cl, ray, rank, total = _lattice_pairs(lat_valid, lat_id, cap)
        # Dead lattice entries never enter the pair arrays, so the merge
        # needs no dump slot for them.
        best_p = torch.full((R,), _MISS_BITS, dtype=torch.int32,
                            device=o.device)
        if cl.numel():
            Fp, items = _pair_inputs(o, d, tlo, tmax_p, cl, ray, rank, SP)
            packed = pair_hit(Fp, cs.G3, items, col_bits, guard_tmax,
                              precision=precision, G3b=cs.G3b)
            best_p.scatter_reduce_(0, ray, packed, "amin")

        rank_w = (best_p >> col_bits) & 7
        col_w = best_p & ((1 << col_bits) - 1)
        ksel = torch.arange(K, device=o.device)[:, None] == rank_w[None, :]
        cluster_w = torch.where(ksel, lat_id, 0).sum(dim=0)
        slot_p = (cluster_w * C + col_w).to(torch.int32)
        return best_p, slot_p, spill, max(total - cap, 0)


def _restart_widths(R: int, SP: int, divisors):
    """The restart passes' width ladder: R / dv for each divisor, rounded
    up to a multiple of SP, at least SP and at most R rounded up."""
    r_pad = -(-R // SP) * SP
    return sorted({min(r_pad, max(SP, (-(-R // dv // SP)) * SP))
                   for dv in divisors})


def _compact(unresolved, widths):
    """The unresolved rays of a restart pass, at the smallest width of the
    ladder that holds them (the largest otherwise: the rest wait for the
    next pass). Returns (uidx, idx, valid): their indices, the same padded
    with 0 to the width, and the mask of real rows; None when no ray is
    unresolved. Reads the count on the host."""
    with span("racc.sparse.read.restart"):
        n_un = int(unresolved.sum())
        if n_un == 0:
            return None
        Rs = next((w for w in widths if n_un <= w), widths[-1])
        uidx = unresolved.nonzero().squeeze(1)[:Rs]
        idx = torch.zeros(Rs, dtype=torch.int64, device=unresolved.device)
        idx[:uidx.numel()] = uidx
        valid = torch.arange(Rs, device=unresolved.device) < uidx.numel()
        return uidx, idx, valid


def trace_sparse(cs: ClusterScene, rays: Rays, env=None, active=None,
                 k_pairs: int = 4, pair_budget: int = 3, sp_tile: int = 1024,
                 max_passes: int = 4, k_first: int | None = None,
                 k_restart: int | None = None, precision: str = "highest"):
    """Pair-centric closest-hit trace, spill-exact multipass. Returns
    (MxuHits, overflow): ``overflow`` counts truncated pairs and rays still
    unresolved after ``max_passes`` (knobs as in the JAX function). With
    ``env``, the environment's radiance along each active miss is folded
    into ``miss_rgb`` after the exact tmax post-filter."""
    with span("racc.sparse"):
        if not 1 <= k_pairs <= 8:
            raise ValueError("k_pairs must be in [1, 8]: rank rides in 3 bits")
        k_first = k_pairs if k_first is None else k_first
        k_restart = k_pairs if k_restart is None else k_restart
        if not (1 <= k_first <= 8 and 1 <= k_restart <= 8):
            raise ValueError("k_first and k_restart must be in [1, 8]")
        R = rays.o.shape[0]
        C = cs.cluster_size
        n_c = cs.n_clusters
        low_mask = (1 << (max((C - 1).bit_length(), 1) + 3)) - 1
        K_r = min(k_restart, n_c)
        SP = sp_tile
        id_bits = max((cs.bb.shape[0] - 1).bit_length(), 1)
        spill_clear = ~((1 << id_bits) - 1)

        inv_d = safe_inv_dir(rays.d)
        tmin = rays.tmin
        tmax0 = (rays.tmax if active is None
                 else torch.where(active, rays.tmax,
                                  torch.full_like(rays.tmax, -1.0)))

        def decode_t(b):
            """Packed best -> conservative upper bound of the winner's t: the
            cleared low bits and the score's reciprocal rounding put the
            packed value at most ~2^-12 below the true t; the 2^-11 inflation
            keeps the bound one-sided."""
            return (b & ~low_mask).view(torch.float32) * (1.0 + 2.0 ** -11)

        def decode_spill(s):
            return (s & spill_clear).view(torch.float32)

        # ---- pass 1: full width, k_first nearest ----
        best, slot, spill, overflow = _sparse_pass(
            cs, rays.o, rays.d, inv_d, tmin, tmax0, min(k_first, n_c), SP,
            pair_budget, guard_tmax=False, precision=precision)
        spill_e = decode_spill(spill)
        unresolved = ((tmax0 > 0) & (spill < _INF_PACK)
                      & (spill_e < torch.minimum(decode_t(best), tmax0)))
        tlo = torch.where(unresolved, spill_e, tmin)
        prev = spill

        # ---- restart passes: compacted unresolved set, width-bucketed ----
        widths = _restart_widths(R, SP, (64, 16, 4) if k_first < k_pairs
                                 else (64, 16))
        n_pass = 1
        while n_pass < max_passes:
            pending = _compact(unresolved, widths)
            if pending is None:
                break
            uidx, idx, valid = pending
            nv = uidx.numel()
            d_s = rays.d[idx]
            best_s = best[idx]
            tmax_r = tmax0[idx]
            tmax_s = torch.where(valid,
                                 torch.minimum(decode_t(best_s), tmax_r),
                                 torch.full_like(tmax_r, -1.0))
            bp, sp_p, spill_s, trunc_s = _sparse_pass(
                cs, rays.o[idx], d_s, safe_inv_dir(d_s), tlo[idx], tmax_s, K_r,
                SP, K_r, prev_packed=prev[idx], guard_tmax=False,
                precision=precision)
            merged = torch.minimum(bp, best_s)
            slot_m = torch.where(bp < best_s, sp_p, slot[idx])
            spill_es = decode_spill(spill_s)
            unres_s = (valid & (spill_s < _INF_PACK)
                       & (spill_es < torch.minimum(decode_t(merged), tmax_r)))
            tlo_m = torch.where(unres_s, spill_es, tlo[idx])
            best[uidx] = merged[:nv]
            slot[uidx] = slot_m[:nv]
            tlo[uidx] = tlo_m[:nv]
            prev[uidx] = spill_s[:nv]
            unresolved[uidx] = unres_s[:nv]
            n_pass += 1
            overflow += trunc_s

        hit = best < _MISS_BITS
        attr, tri, t, u, v = reconstruct(cs, rays, torch.where(hit, slot, 0))
        # The kernel ran without the tmax guard: enforce the window exactly on
        # the refined t (the packed min picked the nearest valid hit, so
        # "nearest > tmax" means no in-window hit exists).
        hit = hit & (t < rays.tmax)
        overflow = unresolved.sum() + overflow
        return MxuHits(hits=make_hits(rays, hit, tri, t, u, v, env, active),
                       attrs=attr), overflow


def trace_occlusion_sparse(cs: ClusterScene, rays: Rays, active=None,
                           k_pairs: int = 4, pair_budget: int = 3,
                           sp_tile: int = 1024, max_passes: int = 4,
                           k_restart: int | None = None,
                           precision: str = "highest"):
    """Any-hit occlusion query on the pair engine: True where some triangle
    blocks the ray within [tmin, tmax].

    Pass 1 tests each ray's ``k_pairs`` nearest clusters with the tmax
    guard on; an unoccluded ray whose spill entry lies inside its window
    restarts from that entry with its tmax unchanged (occlusion never
    narrows it), on the compacted unresolved set, until ``max_passes``.
    Returns (occluded (R,) bool, under_resolved): rays still unresolved at
    the pass cap are reported unoccluded and counted, with truncated
    pairs, in ``under_resolved``."""
    with span("racc.sparse"):
        if not 1 <= k_pairs <= 8:
            raise ValueError("k_pairs must be in [1, 8]: rank rides in 3 bits")
        k_restart = k_pairs if k_restart is None else k_restart
        if not 1 <= k_restart <= 8:
            raise ValueError("k_restart must be in [1, 8]")
        R = rays.o.shape[0]
        n_c = cs.n_clusters
        K_r = min(k_restart, n_c)
        SP = sp_tile
        id_bits = max((cs.bb.shape[0] - 1).bit_length(), 1)
        spill_clear = ~((1 << id_bits) - 1)

        def decode_spill(s):
            return (s & spill_clear).view(torch.float32)

        inv_d = safe_inv_dir(rays.d)
        tmin = rays.tmin
        tmax0 = (rays.tmax if active is None
                 else torch.where(active, rays.tmax,
                                  torch.full_like(rays.tmax, -1.0)))

        best, _, spill, under = _sparse_pass(
            cs, rays.o, rays.d, inv_d, tmin, tmax0, min(k_pairs, n_c), SP,
            pair_budget, guard_tmax=True, precision=precision)
        occluded = best < _MISS_BITS
        spill_e = decode_spill(spill)
        unresolved = ((tmax0 > 0) & ~occluded & (spill < _INF_PACK)
                      & (spill_e < tmax0))
        tlo = torch.where(unresolved, spill_e, tmin)
        prev = spill

        # Restart passes: the ladder tops out at R/8 (shadow rays can leave a
        # longer unresolved tail than closest-hit, having no tmax shrink).
        widths = _restart_widths(R, SP, (64, 8))
        n_pass = 1
        while n_pass < max_passes:
            pending = _compact(unresolved, widths)
            if pending is None:
                break
            uidx, idx, valid = pending
            nv = uidx.numel()
            d_s = rays.d[idx]
            tmax_s = torch.where(valid, tmax0[idx], -1.0)
            bp, _, spill_s, trunc_s = _sparse_pass(
                cs, rays.o[idx], d_s, safe_inv_dir(d_s), tlo[idx], tmax_s, K_r,
                SP, K_r, prev_packed=prev[idx], guard_tmax=True,
                precision=precision)
            occ_s = (bp < _MISS_BITS) | occluded[idx]
            spill_es = decode_spill(spill_s)
            unres_s = (valid & ~occ_s & (spill_s < _INF_PACK)
                       & (spill_es < tmax_s))
            occluded[uidx] = occ_s[:nv]
            tlo[uidx] = torch.where(unres_s, spill_es, tlo[idx])[:nv]
            prev[uidx] = spill_s[:nv]
            unresolved[uidx] = unres_s[:nv]
            n_pass += 1
            under += trunc_s
        return occluded, unresolved.sum() + under
