"""Dense work-queue engine: closest hit (the primaries' engine) and any hit
(the primaries' shadow rays).

Counterpart of ``rayaccel_tpu/ops/trace_pallas.py``: the dense cull and
per-tile front-to-back cluster queue (``_cull_and_queue``, ``:186-262``,
which the JAX package left to XLA) as the hand-written CUDA kernels of
``csrc/dense_cull.cu``, the closest-hit kernel K1 (``_kernel``,
``:77-183``) as ``csrc/dense_hit.cu`` and the any-hit kernel K4
(``_occl_kernel``, ``:265-324``) as ``csrc/dense_occl.cu``, each beside
its plain torch version; the winner reconstruction and the environment
fold of ``trace_mxu_pallas`` (``:492-528``); and ``trace_occlusion_pallas``
(``:363-409``) as :func:`trace_occlusion_dense`.

The Pallas wrapper flattened the queue into one padded item list and
dispatched over a static ladder of capacity buckets. A CUDA grid is sized
at launch, so the queue stays as (T, tile_cap) rows with per-tile counts;
no host sync is needed. Clamping (``tile_cap``), K-step padding and the
overflow count are the JAX package's. The walk is gated finer than the
Pallas kernel's tile: each kernel splits a tile across CTAs of
``CTA_RAYS`` rays (:func:`cta_order`), and each CTA keeps the queued
clusters whose box one of its rays enters (the cull's slab test, on the
scene's boxes: the kernels' ``boxes`` argument). A warp (``WARP_RAYS``
rays) skips a kept cluster none of its rays enters or whose CTA entry
passes every best hit (K1) or every unoccluded tmax (K4) of its rays, and
a ray takes the candidates of the boxes it enters only, so K1's answer
is the closest hit over the queued clusters the ray enters (the Pallas
kernel took every queued cluster's: they differ only where a hit lies
outside every box the ray's slab test enters, a float edge case). A
cluster is skipped only where it cannot change an answer, so the group
size does not change the output of the fp32 product; the plain versions
take it as ``group`` so that the card compares like with like and the
tests can show that. One decided
difference: ``trace_occlusion_pallas`` discards the queue's overflow count
(``:394``), so a shadow ray whose blocker sits in a clamped-away cluster
is reported lit and nothing counts it; :func:`trace_occlusion_dense`
returns the count.

``precision`` is the JAX package's: "highest" multiplies in fp32,
"default" rounds the features (F's columns 0-9, all of G3) to bf16 and
multiplies with one bf16 pass (the TPU's ``Precision.DEFAULT``); on a card
the bf16 variants of K1 and K4 run it on the tensor cores, reading the
scene's bf16 copy of G3 in fragment order (``ClusterScene.G3b``). The
decode, and F's tmin and tmax_eff columns, stay fp32 in both. The bf16
variants' warps hold ``BF16_WARP_RAYS`` rays, and their walk is not
group-invariant: a bf16 t can fall just below a box entry computed in
fp32, so the group can change a winner, and the plain versions walk in
the kernel's group at each precision. For the same reason they keep the
CTA and warp gates but not the per-ray one: a bf16 hit can lie just
outside the box the ray's fp32 slab test enters, and Precision.DEFAULT
keeps it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rayaccel_tpu_torch.environment import sample_environment
from rayaccel_tpu_torch.ops import _kernels
from rayaccel_tpu_torch.ops.intersect import cross3, dot3, safe_inv_dir
from rayaccel_tpu_torch.ops.trace_mxu import INF, MxuHits, _ray_features
from rayaccel_tpu_torch.scene.clusters import (ATTR_GEOM_COL, ATTR_TRI_ID_COL,
                                               ClusterScene)
from rayaccel_tpu_torch.types import Hits, INVALID_TRIANGLE, Rays
from rayaccel_tpu_torch.utils.spans import span

K_PER_STEP = 4
DEFAULT_TILE_CAP = 256
_COL_BITS = 7           # candidate column rides in the score's low mantissa
_COL_MASK = (1 << _COL_BITS) - 1
_INT_MIN = -0x80000000
# The dense kernels' walk shape (``csrc/common.cuh``: kCtaRays, kWarpRays),
# one for K1 and K4, chosen on the card: a CTA takes 64 rays of one tile, so
# a tile must be a multiple of 64, and each warp bounds 8 of them (two rays
# a thread, 8 threads on each pair). The plain versions' default early-out
# group is the kernel's warp, the finest bound it keeps; the CTA's rays
# gate which clusters it stages and its warps test.
CTA_RAYS = 64
WARP_RAYS = 8
# The bf16 variants' warp (common.cuh: kFragRays), chosen on the card: 16
# rays, one tensor-core A fragment; a CTA takes CTA_RAYS rays as well.
BF16_WARP_RAYS = 16
# The queue kernel's largest tile_cap (csrc/dense_cull.cu: kMaxCap): a
# row's kept keys, 8 bytes each, sit in one CTA's shared memory.
QUEUE_MAX_CAP = 16384
# The queue entries a CTA of K1 or K4 gates at a time (csrc/common.cuh:
# kGateRows); the staging starts anew at each such window.
GATE_ROWS = 256
# The lanes of one of the renderer's blocks of 32 x 16 pixels
# (render/tiled.py:block_swizzle, 32 lanes a pixel row): on a tile of whole
# blocks each CTA of K1 and K4 takes a square of 8 x 8 pixels
# (csrc/common.cuh:cta_row, chosen on the card).
BLOCK_LANES = 512


def use_bf16(precision: str) -> bool:
    """Whether ``precision`` ("highest" or "default", the JAX package's
    values) takes the bf16 product."""
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    return precision == "default"


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even) and back to float32: an
    operand of the one-pass bf16 product, whose products of two bf16
    values are exact in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def check_tile(tile: int) -> None:
    """Raises unless the dense kernels take a queue tile of ``tile`` rays."""
    if tile < CTA_RAYS or tile % CTA_RAYS:
        raise ValueError(f"the dense kernels take a tile that is a positive "
                         f"multiple of {CTA_RAYS} rays, got {tile}")


def walk_group(tile: int, precision: str = "highest") -> int:
    """The plain versions' default early-out group: the kernel's warp at
    ``precision`` (``WARP_RAYS``, or ``BF16_WARP_RAYS`` for the bf16
    variants), or on a tile it does not divide the largest group that
    does."""
    return math.gcd(tile, BF16_WARP_RAYS if use_bf16(precision)
                    else WARP_RAYS)


def _slab(o, inv_d, tmin, tmax, bbmin, bbmax):
    """The slab test of rays (o, inv_d (..., 3), window [tmin, tmax] (...))
    against boxes (bbmin, bbmax (..., 3)), broadcast: (t0, t1), the window
    inside the box, which the ray enters where ``t0 <= t1`` (a NaN fails).
    The cull's and the walk's gate's test (``csrc/common.cuh:slab``), bit
    for bit."""
    t0, t1 = tmin, tmax
    for a in range(3):
        tn = (bbmin[..., a] - o[..., a]) * inv_d[..., a]
        tf = (bbmax[..., a] - o[..., a]) * inv_d[..., a]
        t0 = torch.maximum(t0, torch.minimum(tn, tf))
        t1 = torch.minimum(t1, torch.maximum(tn, tf))
    return t0, t1


def _slab_entries(o, inv_d, tmin, tmax, bbmin, bbmax):
    """(R, n) entry distance of every ray into every box over [tmin, tmax]
    (``INF`` where the slab test misses)."""
    t0, t1 = _slab(o[:, None], inv_d[:, None], tmin[:, None], tmax[:, None],
                   bbmin[None], bbmax[None])
    return torch.where(t0 <= t1, torch.clamp_min(t0, 0.0),
                       torch.full_like(t0, INF))


def _check_queue(k_step: int, tile_cap: int) -> None:
    if tile_cap % k_step != 0 or tile_cap < k_step:
        raise ValueError(f"tile_cap {tile_cap} must be a positive multiple "
                         f"of k_step {k_step}")


def cull_and_queue(cs: ClusterScene, o, inv_d, tmin, tmax_eff, T: int,
                   tile: int, k_step: int = K_PER_STEP,
                   tile_cap: int = DEFAULT_TILE_CAP):
    """Dense cull + front-to-back per-tile work queue.

    Returns (q_cluster (T, tile_cap) int32, q_entry (T, tile_cap) int32
    entry-distance bits, q_count (T,) int32, overflow () int64). Row t
    lists the clusters any ray of tile t overlaps, nearest tile entry
    first (ties by cluster id); cluster 0 is forced into every tile so
    every row is non-empty; counts are padded to a multiple of ``k_step``
    by repeating the farthest cluster and clamped to ``tile_cap``, and the
    clusters a clamp drops are counted in ``overflow``. A lane with
    tmax_eff below tmin (an inactive lane: -1) enters nothing.

    On a CUDA tensor this launches ``csrc/dense_cull.cu`` (the tile
    minima, then the rows; no (R, n_c) tensor is written), which takes a
    ``tile_cap`` up to :data:`QUEUE_MAX_CAP` and gives an entry of -0.0 as
    +0.0; ``cull_and_queue.launches`` counts its engagements. On a CPU
    tensor it runs :func:`cull_and_queue_plain`."""
    if o.device.type == "cpu":
        return cull_and_queue_plain(cs, o, inv_d, tmin, tmax_eff, T, tile,
                                    k_step, tile_cap)
    _check_queue(k_step, tile_cap)
    if tile_cap > QUEUE_MAX_CAP:
        raise ValueError(f"the queue kernel takes a tile_cap up to "
                         f"{QUEUE_MAX_CAP}, got {tile_cap}")
    if T < 0 or tile < 1:
        raise ValueError(f"T {T} and tile {tile} must be >= 0 and >= 1")
    R = T * tile
    n_c = cs.cl_bbmin.shape[0]
    if n_c < 1:
        raise ValueError("the scene has no clusters")
    o, inv_d, tmin, tmax_eff = (x.contiguous()
                                for x in (o, inv_d, tmin, tmax_eff))
    _kernels.require(o, "o", torch.float32, (R, 3))
    _kernels.require(inv_d, "inv_d", torch.float32, (R, 3))
    _kernels.require(tmin, "tmin", torch.float32, (R,))
    _kernels.require(tmax_eff, "tmax_eff", torch.float32, (R,))
    _kernels.require(cs.cl_bbmin, "cl_bbmin", torch.float32, (n_c, 3))
    _kernels.require(cs.cl_bbmax, "cl_bbmax", torch.float32, (n_c, 3))
    dev = o.device
    tile_bits = torch.empty((T, n_c), dtype=torch.int32, device=dev)
    q_cluster = torch.empty((T, tile_cap), dtype=torch.int32, device=dev)
    q_entry = torch.empty((T, tile_cap), dtype=torch.int32, device=dev)
    q_count = torch.empty((T,), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    _kernels.check(_kernels.library().racc_cull_queue(
        _kernels.ptr(o), _kernels.ptr(inv_d), _kernels.ptr(tmin),
        _kernels.ptr(tmax_eff), _kernels.ptr(cs.cl_bbmin),
        _kernels.ptr(cs.cl_bbmax), _kernels.ptr(tile_bits),
        _kernels.ptr(q_cluster), _kernels.ptr(q_entry), _kernels.ptr(q_count),
        _kernels.ptr(overflow), T, tile, n_c, k_step, tile_cap,
        _kernels.stream()), "racc_cull_queue")
    cull_and_queue.launches += 1
    return q_cluster, q_entry, q_count, overflow


cull_and_queue.launches = 0


def cull_and_queue_plain(cs: ClusterScene, o, inv_d, tmin, tmax_eff, T: int,
                         tile: int, k_step: int = K_PER_STEP,
                         tile_cap: int = DEFAULT_TILE_CAP):
    """Plain torch version of :func:`cull_and_queue`: the (R, n_c) entry
    tensor, its per-tile minimum and a stable sort of each row."""
    _check_queue(k_step, tile_cap)
    entry = _slab_entries(o, inv_d, tmin, tmax_eff, cs.cl_bbmin, cs.cl_bbmax)
    tile_entry = entry.reshape(T, tile, -1).amin(dim=1)          # (T, n_c)
    tile_entry[:, 0] = torch.clamp_max(tile_entry[:, 0], 0.0)
    sorted_entry, order = torch.sort(tile_entry, dim=1, stable=True)
    counts = (tile_entry < INF).sum(dim=1)
    counts_kept = torch.clamp_max(-(-counts // k_step) * k_step, tile_cap)
    overflow = torch.clamp_min(counts - counts_kept, 0).sum()
    pos = torch.arange(tile_cap, device=o.device)[None, :]
    rank = torch.minimum(pos, counts[:, None] - 1)
    q_cluster = order.gather(1, rank).to(torch.int32)
    q_entry = sorted_entry.gather(1, rank).view(torch.int32)
    return (q_cluster.contiguous(), q_entry.contiguous(),
            counts_kept.to(torch.int32), overflow)


def _candidates(Ft, G3, cluster, precision: str = "highest"):
    """The bilinear decode of the dense kernels for tiles of ray features
    Ft (n, tile, 10) against one cluster each (n,): (inside, |det|, ts),
    where ``inside`` is the sign-bit and |u + v| <= |det| test and ts the
    t numerator with det's sign folded in. At ``precision="default"`` both
    operands are rounded to bf16 first."""
    C = G3.shape[1] // 4
    G = G3[cluster, :, :10]
    if use_bf16(precision):
        Ft, G = round_bf16(Ft), round_bf16(G)
    S = torch.bmm(Ft, G.transpose(1, 2))
    det, u, v, tn = S[..., :C], S[..., C:2 * C], S[..., 2 * C:3 * C], S[..., 3 * C:]
    det_i = det.view(torch.int32)
    sign_ok = ((u.view(torch.int32) ^ det_i)
               | (v.view(torch.int32) ^ det_i)) >= 0
    ad = torch.abs(det)
    ts = (tn.view(torch.int32) ^ (det_i & -0x80000000)).view(torch.float32)
    return sign_ok & (torch.abs(u + v) <= ad), ad, ts


def cluster_boxes(cs: ClusterScene):
    """The clusters' boxes (cl_bbmin, cl_bbmax) that K1's and K4's walk
    gates by: the ``boxes`` argument of the dense kernels."""
    return cs.cl_bbmin, cs.cl_bbmax


def fragment_copy(G3b, n_c: int, C: int, precision: str):
    """The bf16 fragment copy a launch at ``precision`` reads: at
    "default" ``G3b`` (the scene's ``ClusterScene.G3b``, required there),
    checked against a scene of n_c clusters of C; at "highest" None."""
    if not use_bf16(precision):
        return None
    if G3b is None:
        raise ValueError("precision='default' on a card takes G3b, the "
                         "scene's bf16 fragment copy (ClusterScene.G3b)")
    _kernels.require(G3b, "G3b", torch.int32, (n_c, -(-C // 4), 32, 4))
    return G3b


def _dense_launch(fn, name, out, F, G3, G3b, boxes, q_cluster, q_entry,
                  q_count, tile: int, walked, precision: str):
    """Validate the arguments of a dense kernel and launch it: R / CTA_RAYS
    CTAs, at ``precision="default"`` the bf16 variant on ``G3b``, G3's
    fragment copy. ``boxes`` is (cl_bbmin, cl_bbmax), the clusters' boxes
    the walk's gate tests. ``walked`` (optional, a (2,) int64 CUDA tensor)
    gains the (ray, cluster) pairs the kernel's warps tested and the
    clusters its CTAs staged: with ``q_count`` the host has the share the
    gate saves, 1 - walked / (rays x queue length) and 1 - staged / (CTAs
    x queue length). No frame reads it."""
    T, cap = q_cluster.shape
    R = T * tile
    check_tile(tile)
    _kernels.require(F, "F", torch.float32, (R, 16))
    _kernels.require(G3, "G3", torch.float32)
    n_c = G3.shape[0]
    C = G3.shape[1] // 4
    G3b = fragment_copy(G3b, n_c, C, precision)
    bbmin, bbmax = boxes
    _kernels.require(bbmin, "bbmin", torch.float32, (n_c, 3))
    _kernels.require(bbmax, "bbmax", torch.float32, (n_c, 3))
    _kernels.require(q_cluster, "q_cluster", torch.int32)
    _kernels.require(q_entry, "q_entry", torch.int32, (T, cap))
    _kernels.require(q_count, "q_count", torch.int32, (T,))
    if walked is not None:
        _kernels.require(walked, "walked", torch.int64, (2,))
    _kernels.check(fn(
        _kernels.ptr(F), _kernels.ptr(G3),
        None if G3b is None else _kernels.ptr(G3b), _kernels.ptr(bbmin),
        _kernels.ptr(bbmax), _kernels.ptr(q_cluster), _kernels.ptr(q_entry),
        _kernels.ptr(q_count), _kernels.ptr(out),
        None if walked is None else _kernels.ptr(walked), T, tile, cap, C,
        _kernels.stream()), name)


def cta_order(R: int, tile: int, device=None) -> torch.Tensor:
    """The rows of F in the dense kernels' CTA order (R,): CTA c takes rows
    ``order[64 c:64 c + 64]``, its warps runs of 8 (fp32) or 16 (bf16) of
    them. On a tile of whole ``BLOCK_LANES`` blocks, CTA c of a block takes
    its square of 8 x 8 pixels (c // 4, c % 4); any other tile, runs of
    64 lanes."""
    i = torch.arange(R, device=device)
    if tile % BLOCK_LANES:
        return i
    c, k = i % BLOCK_LANES // CTA_RAYS, i % CTA_RAYS
    return (i - i % BLOCK_LANES + (c // 4 * 8 + k // 8) * 32 + c % 4 * 8
            + k % 8)


def _gated_walk(F, boxes, q_cluster, q_entry, q_count, tile: int,
                group: int, bound, test, walked=None) -> None:
    """The plain versions' walk (``csrc/common.cuh:walk_ring``) on F in
    the kernels' CTA order (:func:`cta_order`): each tile's queue row in
    order, all groups of ``group`` consecutive rays in lockstep, gated by
    the rays of their CTA (``CTA_RAYS`` consecutive rays, or the least
    multiple of ``group`` that holds them; on a tile neither divides, the
    largest that divides it). At row j a ray enters its tile's j-th
    cluster where the cull's slab test (on [tmin, tmax_eff], F's d
    inverted as :func:`safe_inv_dir` does) says so, and a group tests the
    cluster where one of its rays enters the box and the least entry of
    its CTA's rays that do is at most the group's ``bound`` (a signed
    compare). ``test(groups, cluster, enter)`` tests the groups ``groups``
    against their clusters, ``enter`` (len(groups), group) masking the
    rays that take a box's candidates, and returns their new bounds.
    ``walked`` (optional, a (2,) int64 tensor) gains the (ray, cluster)
    pairs tested and the clusters the kernel's CTAs stage on these
    inputs (:func:`_staged`; meaningful at the kernel's group)."""
    if tile % group:
        raise ValueError(f"group {group} does not divide tile {tile}")
    bbmin, bbmax = boxes
    T = q_cluster.shape[0]
    R = F.shape[0]
    G = R // group
    cta = math.gcd(tile, math.lcm(group, CTA_RAYS))
    dev = F.device
    gtile = torch.arange(G, device=dev) // (tile // group)
    gcta = torch.arange(G, device=dev) // (cta // group)
    entry, count = q_entry[gtile], q_count[gtile]
    o = F[:, 3:6].reshape(T, tile, 3)
    inv = safe_inv_dir(F[:, 0:3]).reshape(T, tile, 3)
    tmin = F[:, 10].reshape(T, tile)
    tmax = F[:, 11].reshape(T, tile)
    rows = int(q_count.max()) if T else 0
    trace = None if walked is None else dict(least=[], any=[], bound=[],
                                             bound0=bound.clone())
    tested = 0
    for j in range(rows):
        # Entries rise along a row, each CTA's entry is at least its
        # tile's, and bounds only shrink: once no group is left, none
        # comes back (only the count needs the rest).
        alive = (j < count) & (entry[:, j] <= bound)
        if trace is None and not bool(alive.any()):
            break
        cl = q_cluster[:, j].long()
        t0, t1 = _slab(o, inv, tmin, tmax, bbmin[cl][:, None],
                       bbmax[cl][:, None])
        inside = t0 <= t1
        least = torch.where(inside, torch.clamp_min(t0, 0.0) + 0.0,
                            torch.full_like(t0, INF))
        least = least.reshape(-1, cta).amin(dim=1).view(torch.int32)
        enter = inside.reshape(G, group)
        some = enter.any(dim=1)
        groups = (alive & some & (least[gcta] <= bound)).nonzero().squeeze(1)
        if groups.numel():
            bound[groups] = test(groups, q_cluster[gtile[groups], j],
                                 enter[groups])
            tested += groups.numel() * group
        if trace is not None:
            trace["least"].append(least)
            trace["any"].append(some)
            trace["bound"].append(bound.clone())
    if walked is not None:
        staged = _staged(trace, q_entry, q_count, tile, cta, group)
        walked += torch.tensor([tested, staged], dtype=walked.dtype,
                               device=walked.device)


def _staged(trace, q_entry, q_count, tile: int, cta: int, group: int) -> int:
    """The clusters the kernel's CTAs stage on the walk ``trace`` recorded
    (each row's CTA entries and groups whose rays enter it, the bounds
    after each row): a CTA gates ``GATE_ROWS`` entries of its row at a
    time, stops before a window whose first tile entry passes all its
    bounds, and stages, in row order, each entry some group of it would
    test at the bounds published after the last but one cluster it
    staged (the two-stage ring: the first two at the window's start)."""
    warps = cta // group
    cap = q_entry.shape[1]
    window = min(cap, GATE_ROWS)
    rows = len(trace["least"])
    if rows == 0:
        return 0
    least = torch.stack(trace["least"]).cpu().numpy()           # (n, CTAs)
    some = torch.stack(trace["any"]).cpu().numpy()              # (n, G)
    after = torch.stack(trace["bound"]).cpu().numpy()           # (n, G)
    bound0 = trace["bound0"].cpu().numpy()
    q_entry = q_entry.cpu().numpy()
    q_count = q_count.cpu().numpy()
    staged = 0
    for c in range(least.shape[1]):
        t = c * cta // tile
        w = slice(c * warps, (c + 1) * warps)
        n = int(q_count[t])
        for base in range(0, n, window):
            now = bound0[w] if base == 0 else after[base - 1, w]
            if q_entry[t, base] > now.max():
                break
            kept = [j for j in range(base, min(base + window, n))
                    if some[j, w].any()]
            order, nxt = [], 0

            def stage_next(b):
                nonlocal nxt
                while nxt < len(kept):
                    j = kept[nxt]
                    nxt += 1
                    if (some[j, w] & (least[j, c] <= b)).any():
                        order.append(j)
                        return

            stage_next(now)
            stage_next(now)
            s = 0
            while s < len(order):
                stage_next(after[order[s], w])
                s += 1
            staged += len(order)
    return staged


def dense_closest_hit(F, G3, q_cluster, q_entry, q_count, tile: int,
                      k_step: int = K_PER_STEP, *, boxes, walked=None,
                      precision: str = "highest",
                      G3b=None) -> torch.Tensor:
    """K1: packed closest hit of each ray over the clusters of its tile's
    queue whose box it enters.

    F (T*tile, 16) ray rows [d, o, d x o, 1, tmin, tmax_eff, 0...]
    (tmax_eff = -1 marks an inactive lane); G3 (n_c, 4C, 16); ``boxes``
    the clusters' (cl_bbmin, cl_bbmax); the queue as returned by
    :func:`cull_and_queue`. ``k_step`` is ignored: it is the queue's
    padding step, and the walk bounds cluster by cluster.
    Returns (2, R) int32: row 0 the packed best (score bits, low 7 bits =
    column; the tmax_eff bits on a miss), row 1 the slot cluster * C +
    column (-1 on a miss).

    On a CUDA tensor this launches ``csrc/dense_hit.cu`` (R / CTA_RAYS
    CTAs, known without a host sync; ``walked`` counts the pairs its warps
    tested and the clusters its CTAs staged), at ``precision="default"``
    its bf16 tensor-core variant, which reads ``G3b`` (the scene's
    ``ClusterScene.G3b``, required there); on a CPU tensor it runs
    :func:`dense_closest_hit_plain`, which needs no ``G3b``.
    ``dense_closest_hit.launches_bf16`` counts the bf16 launches among
    ``dense_closest_hit.launches``."""
    bf16 = use_bf16(precision)
    if F.device.type == "cpu":
        return dense_closest_hit_plain(F, G3, q_cluster, q_entry, q_count,
                                       tile, k_step, boxes=boxes,
                                       walked=walked, precision=precision)
    out = torch.empty((2, F.shape[0]), dtype=torch.int32, device=F.device)
    _dense_launch(_kernels.library().racc_dense_hit, "racc_dense_hit", out,
                  F, G3, G3b, boxes, q_cluster, q_entry, q_count, tile,
                  walked, precision)
    dense_closest_hit.launches += 1
    dense_closest_hit.launches_bf16 += bf16
    return out


dense_closest_hit.launches = 0
dense_closest_hit.launches_bf16 = 0


def dense_closest_hit_plain(F, G3, q_cluster, q_entry, q_count, tile: int,
                            k_step: int = K_PER_STEP, *, boxes,
                            group: Optional[int] = None, walked=None,
                            precision: str = "highest") -> torch.Tensor:
    """Plain torch version of K1: the same gated queue walk
    (:func:`_gated_walk`), all groups of ``group`` rays in lockstep
    (default :func:`walk_group`, the kernel's warp). A group's bound is
    the largest best hit of its rays (an all-inactive group holds negative
    bits and tests nothing); a ray takes a cluster's candidates only where
    it enters the box. ``walked`` as the kernel's; ``k_step`` is
    ignored."""
    group = group or walk_group(tile, precision)
    bf16 = use_bf16(precision)
    C = G3.shape[1] // 4
    order = cta_order(F.shape[0], tile, F.device)
    F = F[order]
    Fm = F.reshape(-1, group, 16)
    tmin = Fm[:, :, 10]
    best = Fm[:, :, 11].contiguous().view(torch.int32).clone()
    slot = torch.full_like(best, -1)
    col = torch.arange(C, dtype=torch.int32, device=F.device)

    def test(groups, cluster, enter):
        inside, ad, ts = _candidates(Fm[groups, :, :10], G3, cluster,
                                     precision)
        score_q = ts * torch.reciprocal(ad)
        valid = inside & (score_q > tmin[groups][:, :, None])
        score = torch.where(valid, score_q, torch.full_like(score_q, 3e38))
        m = ((score.view(torch.int32) & ~_COL_MASK) | col).amin(dim=2)
        b = best[groups]
        better = (enter | bf16) & (m < b)
        slot[groups] = torch.where(better,
                                   cluster[:, None] * C + (m & _COL_MASK),
                                   slot[groups])
        b = torch.where(better, m, b)
        best[groups] = b
        return b.amax(dim=1)

    _gated_walk(F, boxes, q_cluster, q_entry, q_count, tile, group,
                best.amax(dim=1), test, walked)
    out = torch.empty((2, F.shape[0]), dtype=torch.int32, device=F.device)
    out[:, order] = torch.stack([best.reshape(-1), slot.reshape(-1)])
    return out


def reconstruct(cs: ClusterScene, rays: Rays, slot: torch.Tensor):
    """Winner reconstruction: one attribute-row gather per ray, then exact
    Moller-Trumbore on the row's [v0, e1, e2]. ``slot`` must index a real
    row (callers pass 0 for misses). Returns (attrs, tri, t, u, v)."""
    attr = cs.attrs[slot.long()]
    tri = attr[:, ATTR_TRI_ID_COL].contiguous().view(torch.int32)
    v0 = attr[:, ATTR_GEOM_COL + 0:ATTR_GEOM_COL + 3]
    e1 = attr[:, ATTR_GEOM_COL + 3:ATTR_GEOM_COL + 6]
    e2 = attr[:, ATTR_GEOM_COL + 6:ATTR_GEOM_COL + 9]
    d = rays.d
    pvec = cross3(d, e2)
    det = dot3(pvec, e1)
    inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tvec = rays.o - v0
    u = dot3(pvec, tvec) * inv
    qvec = cross3(tvec, e1)
    v = dot3(qvec, d) * inv
    t = dot3(qvec, e2) * inv
    return attr, tri, t, u, v


def make_hits(rays: Rays, hit, tri, t, u, v, env=None, active=None) -> Hits:
    """Hits with misses as INVALID_TRIANGLE at t = tmax, u = v = 0. With an
    environment, ``miss_rgb`` is its radiance along each ray that misses
    while active (zero elsewhere); without one it is zero."""
    zero = torch.zeros_like(t)
    if env is None:
        miss_rgb = torch.zeros_like(rays.o)
    else:
        mask = hit if active is None else hit | ~active
        miss_rgb = torch.where(mask[:, None], 0.0,
                               sample_environment(env, rays.d))
    return Hits(tri=torch.where(hit, tri, INVALID_TRIANGLE),
                t=torch.where(hit, t, rays.tmax),
                u=torch.where(hit, u, zero), v=torch.where(hit, v, zero),
                miss_rgb=miss_rgb)


def _dense_inputs(cs: ClusterScene, rays: Rays, active, tile: int,
                  k_step: int, tile_cap: int):
    """The cull + queue and the feature rows shared by both dense traces:
    (F, q_cluster, q_entry, q_count, overflow)."""
    R = rays.o.shape[0]
    if R % tile:
        raise ValueError(f"ray count {R} is not a multiple of tile {tile}")
    T = R // tile
    inv_d = safe_inv_dir(rays.d)
    tmax_eff = (rays.tmax if active is None
                else torch.where(active, rays.tmax,
                                 torch.full_like(rays.tmax, -1.0)))
    with span("racc.dense.cull"):
        q_cluster, q_entry, q_count, overflow = cull_and_queue(
            cs, rays.o, inv_d, rays.tmin, tmax_eff, T, tile, k_step,
            tile_cap)
    F = _ray_features(rays.o, rays.d)
    F[:, 10] = rays.tmin
    F[:, 11] = tmax_eff
    return F, q_cluster, q_entry, q_count, overflow


def trace_dense(cs: ClusterScene, rays: Rays, env=None, active=None,
                tile: int = 512, k_step: int = K_PER_STEP,
                tile_cap: int = DEFAULT_TILE_CAP,
                precision: str = "highest"):
    """Closest hit of every ray on the dense work-queue engine (the
    counterpart of ``trace_mxu_pallas``), with the environment's radiance
    folded into ``miss_rgb`` when ``env`` is given. Returns (MxuHits,
    overflow)."""
    with span("racc.dense"):
        F, q_cluster, q_entry, q_count, overflow = _dense_inputs(
            cs, rays, active, tile, k_step, tile_cap)
        with span("racc.dense.kernel"):
            out = dense_closest_hit(F, cs.G3, q_cluster, q_entry, q_count,
                                    tile, k_step, boxes=cluster_boxes(cs),
                                    precision=precision, G3b=cs.G3b)
        slot = out[1]
        hit = slot >= 0
        attr, tri, t, u, v = reconstruct(cs, rays, torch.where(hit, slot, 0))
        hits = make_hits(rays, hit, tri, t, u, v, env, active)
    return MxuHits(hits=hits, attrs=attr), overflow


# ---------------------------------------------------------------- K4 ----

def dense_occluded(F, G3, q_cluster, q_entry, q_count, tile: int,
                   k_step: int = K_PER_STEP, *, boxes, walked=None,
                   precision: str = "highest", G3b=None) -> torch.Tensor:
    """K4: any hit of each ray over the clusters of its tile's queue whose
    box it enters.

    Inputs as for :func:`dense_closest_hit` (rows 10/11 of F are tmin and
    tmax_eff; -1 marks an inactive lane). A ray is occluded when some
    triangle of such a cluster has ``sign_ok & |u + v| <= |det| & ts >
    |det| * tmin & ts <= |det| * tmax`` (the exact window, no reciprocal).
    Returns (R,) bool.

    On a CUDA tensor this launches ``csrc/dense_occl.cu`` (the grid,
    ``walked``, ``precision``, ``G3b`` and the ignored ``k_step`` as for K1;
    ``dense_occluded.launches_bf16`` counts the bf16 launches); on a CPU
    tensor it runs :func:`dense_occluded_plain`."""
    bf16 = use_bf16(precision)
    if F.device.type == "cpu":
        return dense_occluded_plain(F, G3, q_cluster, q_entry, q_count,
                                    tile, k_step, boxes=boxes, walked=walked,
                                    precision=precision)
    out = torch.empty((F.shape[0],), dtype=torch.bool, device=F.device)
    _dense_launch(_kernels.library().racc_dense_occluded,
                  "racc_dense_occluded", out, F, G3, G3b, boxes, q_cluster,
                  q_entry, q_count, tile, walked, precision)
    dense_occluded.launches += 1
    dense_occluded.launches_bf16 += bf16
    return out


dense_occluded.launches = 0
dense_occluded.launches_bf16 = 0


def dense_occluded_plain(F, G3, q_cluster, q_entry, q_count, tile: int,
                         k_step: int = K_PER_STEP, *, boxes,
                         group: Optional[int] = None, walked=None,
                         precision: str = "highest") -> torch.Tensor:
    """Plain torch version of K4: the same gated queue walk
    (:func:`_gated_walk`), all groups of ``group`` rays in lockstep
    (default :func:`walk_group`, the kernel's warp). A group's bound is the
    largest tmax bits among its unoccluded rays (occluded and inactive
    rays hold negative bounds, so a group with none left tests nothing); a
    ray takes a cluster's candidates only where it enters the box.
    ``walked`` as the kernel's; ``k_step`` is ignored."""
    group = group or walk_group(tile, precision)
    bf16 = use_bf16(precision)
    order = cta_order(F.shape[0], tile, F.device)
    F = F[order]
    Fm = F.reshape(-1, group, 16)
    tmin = Fm[:, :, 10]
    tmax = Fm[:, :, 11]
    t_bits = tmax.contiguous().view(torch.int32)
    occ = torch.zeros(t_bits.shape, dtype=torch.bool, device=F.device)

    def test(groups, cluster, enter):
        inside, ad, ts = _candidates(Fm[groups, :, :10], G3, cluster,
                                     precision)
        hit = (inside & (ts > ad * tmin[groups][:, :, None])
               & (ts <= ad * tmax[groups][:, :, None])).any(dim=2)
        o = occ[groups] | ((enter | bf16) & hit)
        occ[groups] = o
        return torch.where(o, _INT_MIN, t_bits[groups]).amax(dim=1)

    _gated_walk(F, boxes, q_cluster, q_entry, q_count, tile, group,
                t_bits.amax(dim=1), test, walked)
    out = torch.empty_like(occ.reshape(-1))
    out[order] = occ.reshape(-1)
    return out


def trace_occlusion_dense(cs: ClusterScene, rays: Rays, active=None,
                          tile: int = 512, k_step: int = K_PER_STEP,
                          tile_cap: int = DEFAULT_TILE_CAP,
                          precision: str = "highest"):
    """Any-hit occlusion query on the dense work-queue engine (the
    counterpart of ``trace_occlusion_pallas``): True where some triangle
    blocks the ray within [tmin, tmax]. Returns (occluded (R,) bool,
    overflow): ``overflow`` counts the clusters the queue clamp dropped,
    which the JAX wrapper discards."""
    with span("racc.dense"):
        F, q_cluster, q_entry, q_count, overflow = _dense_inputs(
            cs, rays, active, tile, k_step, tile_cap)
        with span("racc.dense.kernel"):
            occ = dense_occluded(F, cs.G3, q_cluster, q_entry, q_count, tile,
                                 k_step, boxes=cluster_boxes(cs),
                                 precision=precision, G3b=cs.G3b)
    return occ, overflow
