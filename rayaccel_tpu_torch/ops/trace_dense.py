"""Dense work-queue engine: closest hit (the primaries' engine) and any hit
(the primaries' shadow rays).

Counterpart of ``rayaccel_tpu/ops/trace_pallas.py``: the dense cull and
per-tile front-to-back cluster queue (``_cull_and_queue``, ``:186-262``)
in plain torch; the closest-hit kernel K1 (``_kernel``, ``:77-183``) as
the hand-written CUDA kernel ``csrc/dense_hit.cu`` and the any-hit kernel
K4 (``_occl_kernel``, ``:265-324``) as ``csrc/dense_occl.cu``, each beside
its plain torch version; the winner reconstruction and the environment
fold of ``trace_mxu_pallas`` (``:492-528``); and ``trace_occlusion_pallas``
(``:363-409``) as :func:`trace_occlusion_dense`.

The Pallas wrapper flattened the queue into one padded item list and
dispatched over a static ladder of capacity buckets. A CUDA grid is sized
at launch, so the queue stays as (T, tile_cap) rows with per-tile counts
and the kernel runs one CTA per ray tile; no host sync is needed. Clamping
(``tile_cap``), K-step padding and the overflow count are the JAX
package's. One decided difference: ``trace_occlusion_pallas`` discards the
queue's overflow count (``:394``), so a shadow ray whose blocker sits in a
clamped-away cluster is reported lit and nothing counts it;
:func:`trace_occlusion_dense` returns the count.
"""

from __future__ import annotations

import torch

from rayaccel_tpu_torch.environment import sample_environment
from rayaccel_tpu_torch.ops import _kernels
from rayaccel_tpu_torch.ops.intersect import cross3, dot3, safe_inv_dir
from rayaccel_tpu_torch.ops.trace_mxu import INF, MxuHits, _ray_features
from rayaccel_tpu_torch.scene.clusters import (ATTR_GEOM_COL, ATTR_TRI_ID_COL,
                                               ClusterScene)
from rayaccel_tpu_torch.types import Hits, INVALID_TRIANGLE, Rays

K_PER_STEP = 4
DEFAULT_TILE_CAP = 256
_COL_BITS = 7           # candidate column rides in the score's low mantissa
_COL_MASK = (1 << _COL_BITS) - 1


def _slab_entries(o, inv_d, tmin, tmax, bbmin, bbmax):
    """(R, n) entry distance of every ray into every box over [tmin, tmax]
    (``INF`` where the slab test misses)."""
    t0 = tmin[:, None].expand(-1, bbmin.shape[0])
    t1 = tmax[:, None].expand(-1, bbmin.shape[0])
    for a in range(3):
        tn = (bbmin[None, :, a] - o[:, a, None]) * inv_d[:, a, None]
        tf = (bbmax[None, :, a] - o[:, a, None]) * inv_d[:, a, None]
        t0 = torch.maximum(t0, torch.minimum(tn, tf))
        t1 = torch.minimum(t1, torch.maximum(tn, tf))
    return torch.where(t0 <= t1, torch.clamp_min(t0, 0.0),
                       torch.full_like(t0, INF))


def cull_and_queue(cs: ClusterScene, o, inv_d, tmin, tmax_eff, T: int,
                   tile: int, k_step: int = K_PER_STEP,
                   tile_cap: int = DEFAULT_TILE_CAP):
    """Dense cull + front-to-back per-tile work queue.

    Returns (q_cluster (T, tile_cap) int32, q_entry (T, tile_cap) int32
    entry-distance bits, q_count (T,) int32, overflow () int64). Row t
    lists the clusters any ray of tile t overlaps, nearest tile entry
    first; cluster 0 is forced into every tile so every row is non-empty;
    counts are padded to a multiple of ``k_step`` by repeating the farthest
    cluster and clamped to ``tile_cap``, and the clusters a clamp drops are
    counted in ``overflow``."""
    if tile_cap % k_step != 0 or tile_cap < k_step:
        raise ValueError(f"tile_cap {tile_cap} must be a positive multiple "
                         f"of k_step {k_step}")
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


def _candidates(Ft, G3, cluster):
    """The bilinear decode of the dense kernels for tiles of ray features
    Ft (n, tile, 10) against one cluster each (n,): (inside, |det|, ts),
    where ``inside`` is the sign-bit and |u + v| <= |det| test and ts the
    t numerator with det's sign folded in."""
    C = G3.shape[1] // 4
    S = torch.bmm(Ft, G3[cluster, :, :10].transpose(1, 2))
    det, u, v, tn = S[..., :C], S[..., C:2 * C], S[..., 2 * C:3 * C], S[..., 3 * C:]
    det_i = det.view(torch.int32)
    sign_ok = ((u.view(torch.int32) ^ det_i)
               | (v.view(torch.int32) ^ det_i)) >= 0
    ad = torch.abs(det)
    ts = (tn.view(torch.int32) ^ (det_i & -0x80000000)).view(torch.float32)
    return sign_ok & (torch.abs(u + v) <= ad), ad, ts


def dense_closest_hit(F, G3, q_cluster, q_entry, q_count, tile: int,
                      k_step: int = K_PER_STEP) -> torch.Tensor:
    """K1: packed closest hit of each ray over its tile's cluster queue.

    F (T*tile, 16) ray rows [d, o, d x o, 1, tmin, tmax_eff, 0...]
    (tmax_eff = -1 marks an inactive lane); G3 (n_c, 4C, 16); the queue as
    returned by :func:`cull_and_queue`. Returns (2, R) int32: row 0 the
    packed best (score bits, low 7 bits = column; the tmax_eff bits on a
    miss), row 1 the slot cluster * C + column (-1 on a miss).

    On a CUDA tensor this launches ``csrc/dense_hit.cu`` (one CTA per ray
    tile; the grid is T, known without a host sync); on a CPU tensor it
    runs :func:`dense_closest_hit_plain`."""
    if F.device.type == "cpu":
        return dense_closest_hit_plain(F, G3, q_cluster, q_entry, q_count,
                                       tile, k_step)
    T, cap = q_cluster.shape
    R = T * tile
    n_c, C4, _ = G3.shape
    _kernels.require(F, "F", torch.float32, (R, 16))
    _kernels.require(G3, "G3", torch.float32)
    _kernels.require(q_cluster, "q_cluster", torch.int32)
    _kernels.require(q_entry, "q_entry", torch.int32, (T, cap))
    _kernels.require(q_count, "q_count", torch.int32, (T,))
    out = torch.empty((2, R), dtype=torch.int32, device=F.device)
    lib = _kernels.library()
    _kernels.check(lib.racc_dense_hit(
        _kernels.ptr(F), _kernels.ptr(G3), _kernels.ptr(q_cluster),
        _kernels.ptr(q_entry), _kernels.ptr(q_count), _kernels.ptr(out),
        T, tile, cap, C4 // 4, k_step, _kernels.stream()), "racc_dense_hit")
    dense_closest_hit.launches += 1
    return out


dense_closest_hit.launches = 0


def dense_closest_hit_plain(F, G3, q_cluster, q_entry, q_count, tile: int,
                            k_step: int = K_PER_STEP) -> torch.Tensor:
    """Plain torch version of K1: the same queue walk, all tiles in
    lockstep, each K-step one batched product over the tiles whose next
    entry has not passed their worst best hit."""
    T = q_cluster.shape[0]
    C = G3.shape[1] // 4
    Fm = F.reshape(T, tile, 16)
    tmin = Fm[:, :, 10]
    best = Fm[:, :, 11].contiguous().view(torch.int32).clone()
    slot = torch.full_like(best, -1)
    worst = torch.clamp_min(best, 0).amax(dim=1)
    col = torch.arange(C, dtype=torch.int32, device=F.device)
    steps = int(q_count.max()) // k_step
    for s in range(steps):
        j = s * k_step
        useful = (j < q_count) & (q_entry[:, j] <= torch.clamp_min(worst, 0))
        tiles = useful.nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        Ft = Fm[tiles, :, :10]
        b = best[tiles]
        sl = slot[tiles]
        for k in range(k_step):
            cluster = q_cluster[tiles, j + k]
            inside, ad, ts = _candidates(Ft, G3, cluster)
            score_q = ts * torch.reciprocal(ad)
            valid = inside & (score_q > tmin[tiles][:, :, None])
            score = torch.where(valid, score_q, torch.full_like(score_q, 3e38))
            sp = (score.view(torch.int32) & ~_COL_MASK) | col
            m = sp.amin(dim=2)
            better = m < b
            sl = torch.where(better, cluster[:, None] * C + (m & _COL_MASK), sl)
            b = torch.where(better, m, b)
        best[tiles] = b
        slot[tiles] = sl
        worst[tiles] = b.amax(dim=1)
    return torch.stack([best.reshape(-1), slot.reshape(-1)])


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
    q_cluster, q_entry, q_count, overflow = cull_and_queue(
        cs, rays.o, inv_d, rays.tmin, tmax_eff, T, tile, k_step, tile_cap)
    F = _ray_features(rays.o, rays.d)
    F[:, 10] = rays.tmin
    F[:, 11] = tmax_eff
    return F, q_cluster, q_entry, q_count, overflow


def trace_dense(cs: ClusterScene, rays: Rays, env=None, active=None,
                tile: int = 512, k_step: int = K_PER_STEP,
                tile_cap: int = DEFAULT_TILE_CAP):
    """Closest hit of every ray on the dense work-queue engine (the
    counterpart of ``trace_mxu_pallas``), with the environment's radiance
    folded into ``miss_rgb`` when ``env`` is given. Returns (MxuHits,
    overflow)."""
    F, q_cluster, q_entry, q_count, overflow = _dense_inputs(
        cs, rays, active, tile, k_step, tile_cap)
    out = dense_closest_hit(F, cs.G3, q_cluster, q_entry, q_count, tile,
                            k_step)
    slot = out[1]
    hit = slot >= 0
    attr, tri, t, u, v = reconstruct(cs, rays, torch.where(hit, slot, 0))
    hits = make_hits(rays, hit, tri, t, u, v, env, active)
    return MxuHits(hits=hits, attrs=attr), overflow


# ---------------------------------------------------------------- K4 ----

def dense_occluded(F, G3, q_cluster, q_entry, q_count, tile: int,
                   k_step: int = K_PER_STEP) -> torch.Tensor:
    """K4: any hit of each ray over its tile's cluster queue.

    Inputs as for :func:`dense_closest_hit` (rows 10/11 of F are tmin and
    tmax_eff; -1 marks an inactive lane). A ray is occluded when some
    queued triangle has ``sign_ok & |u + v| <= |det| & ts > |det| * tmin &
    ts <= |det| * tmax`` (the exact window, no reciprocal). Returns (R,)
    bool.

    On a CUDA tensor this launches ``csrc/dense_occl.cu`` (one CTA per ray
    tile); on a CPU tensor it runs :func:`dense_occluded_plain`."""
    if F.device.type == "cpu":
        return dense_occluded_plain(F, G3, q_cluster, q_entry, q_count,
                                    tile, k_step)
    T, cap = q_cluster.shape
    R = T * tile
    n_c, C4, _ = G3.shape
    _kernels.require(F, "F", torch.float32, (R, 16))
    _kernels.require(G3, "G3", torch.float32)
    _kernels.require(q_cluster, "q_cluster", torch.int32)
    _kernels.require(q_entry, "q_entry", torch.int32, (T, cap))
    _kernels.require(q_count, "q_count", torch.int32, (T,))
    out = torch.empty((R,), dtype=torch.bool, device=F.device)
    lib = _kernels.library()
    _kernels.check(lib.racc_dense_occluded(
        _kernels.ptr(F), _kernels.ptr(G3), _kernels.ptr(q_cluster),
        _kernels.ptr(q_entry), _kernels.ptr(q_count), _kernels.ptr(out),
        T, tile, cap, C4 // 4, k_step, _kernels.stream()),
        "racc_dense_occluded")
    dense_occluded.launches += 1
    return out


dense_occluded.launches = 0


def dense_occluded_plain(F, G3, q_cluster, q_entry, q_count, tile: int,
                         k_step: int = K_PER_STEP) -> torch.Tensor:
    """Plain torch version of K4: the same queue walk, all tiles in
    lockstep. A tile stops once its next entry passes the largest tmax
    among its unoccluded lanes (occluded lanes bound at 0)."""
    T = q_cluster.shape[0]
    Fm = F.reshape(T, tile, 16)
    tmin = Fm[:, :, 10]
    tmax = Fm[:, :, 11]
    t_bits = torch.clamp_min(tmax.contiguous().view(torch.int32), 0)
    occ = torch.zeros((T, tile), dtype=torch.bool, device=F.device)
    bound = t_bits.amax(dim=1)
    steps = int(q_count.max()) // k_step
    for s in range(steps):
        j = s * k_step
        useful = (j < q_count) & (q_entry[:, j] <= bound)
        tiles = useful.nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        Ft = Fm[tiles, :, :10]
        lo = tmin[tiles][:, :, None]
        hi = tmax[tiles][:, :, None]
        o = occ[tiles]
        for k in range(k_step):
            inside, ad, ts = _candidates(Ft, G3, q_cluster[tiles, j + k])
            o = o | (inside & (ts > ad * lo) & (ts <= ad * hi)).any(dim=2)
        occ[tiles] = o
        bound[tiles] = torch.where(o, 0, t_bits[tiles]).amax(dim=1)
    return occ.reshape(-1)


def trace_occlusion_dense(cs: ClusterScene, rays: Rays, active=None,
                          tile: int = 512, k_step: int = K_PER_STEP,
                          tile_cap: int = DEFAULT_TILE_CAP):
    """Any-hit occlusion query on the dense work-queue engine (the
    counterpart of ``trace_occlusion_pallas``): True where some triangle
    blocks the ray within [tmin, tmax]. Returns (occluded (R,) bool,
    overflow): ``overflow`` counts the clusters the queue clamp dropped,
    which the JAX wrapper discards."""
    F, q_cluster, q_entry, q_count, overflow = _dense_inputs(
        cs, rays, active, tile, k_step, tile_cap)
    occ = dense_occluded(F, cs.G3, q_cluster, q_entry, q_count, tile,
                         k_step)
    return occ, overflow
