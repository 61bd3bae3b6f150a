"""The plain cluster engine, and the pieces every cluster engine shares.

Counterpart of ``rayaccel_tpu/ops/trace_mxu.py``: ``MxuHits``,
``_ray_features``, ``trace_mxu`` and ``trace_occlusion_mxu``. Rays are
processed as contiguous tiles. Stage A slab-tests every ray against every
cluster box and orders each tile's clusters front to back; stage B walks
the queue position k in lockstep over all tiles, each step one batched
(tile, 16) x (16, 4C) product per tile (``torch.bmm``, fp32 with TF32 off:
``context.py:init``) decoded as the bilinear Moller-Trumbore form. The
winner's attribute row is fetched with one row gather at the end.

The JAX function is one compiled ``while_loop``; here the loop runs
eagerly. A step of a tile that is no longer live changes nothing, so the
loop reads its stop condition on the host only every ``_CHECK_EVERY``
steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayaccel_tpu_torch.environment import Environment, sample_environment
from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
from rayaccel_tpu_torch.types import INVALID_TRIANGLE, Hits, Rays

INF = 3e38   # the cull's "no overlap" entry distance
_CHECK_EVERY = 4


class MxuHits(NamedTuple):
    """Hits plus the hit triangle's attribute row (scene/clusters.py)."""

    hits: Hits
    attrs: torch.Tensor  # (R, ATTR_COLS)


def _ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """F = [d, o, d x o, 1, 0*6] per ray, (R, 16)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    cx = dy * oz - dz * oy
    cy = dz * ox - dx * oz
    cz = dx * oy - dy * ox
    one = torch.ones_like(dx)
    zero = torch.zeros_like(dx)
    return torch.stack([dx, dy, dz, ox, oy, oz, cx, cy, cz, one,
                        zero, zero, zero, zero, zero, zero], dim=1)


def _cull(cs, rays: Rays, active, tile: int):
    """Stage A: the dense cull and each tile's front-to-back cluster order.
    Returns (tmax_eff (R,), order (T, n_c), sorted_entry (T, n_c),
    count (T,), max_count int)."""
    R = rays.o.shape[0]
    if R % tile:
        raise ValueError(f"wave size {R} not a multiple of tile {tile}")
    T = R // tile
    inv_d = safe_inv_dir(rays.d)
    tmax_eff = (rays.tmax if active is None
                else torch.where(active, rays.tmax, -1.0))
    n_c = cs.n_clusters
    t0 = rays.tmin[:, None].expand(R, n_c)
    t1 = tmax_eff[:, None].expand(R, n_c)
    for a in range(3):
        o_a = rays.o[:, a, None]
        i_a = inv_d[:, a, None]
        tn = (cs.cl_bbmin[None, :, a] - o_a) * i_a
        tf = (cs.cl_bbmax[None, :, a] - o_a) * i_a
        t0 = torch.maximum(t0, torch.minimum(tn, tf))
        t1 = torch.minimum(t1, torch.maximum(tn, tf))
    entry = torch.where(t0 <= t1, t0, INF)                      # (R, n_c)
    tile_entry = entry.reshape(T, tile, n_c).amin(dim=1)        # (T, n_c)
    # Ties are the common case (every cluster that holds the ray origins
    # enters at tmin): the stable sort keeps them in cluster order.
    sorted_entry, order = torch.sort(tile_entry, dim=1, stable=True)
    count = (tile_entry < INF).sum(dim=1)
    return tmax_eff, order, sorted_entry, count, int(count.max())


def _decode(F, cs, c_t):
    """One queue step's products for tiles F (T, tile, 16) against cluster
    ``c_t`` (T,) each: (|det|, u, v, t) numerators with det's sign folded
    in, each (T, tile, C)."""
    C = cs.cluster_size
    S = torch.bmm(F, cs.G3[c_t].transpose(1, 2))                # (T, tile, 4C)
    det = S[:, :, 0 * C:1 * C]
    sgn = torch.where(det < 0, -1.0, 1.0)
    return (torch.abs(det), S[:, :, 1 * C:2 * C] * sgn,
            S[:, :, 2 * C:3 * C] * sgn, S[:, :, 3 * C:4 * C] * sgn)


def trace_occlusion_mxu(cs, rays: Rays, active: torch.Tensor | None = None,
                        tile: int = 512) -> torch.Tensor:
    """Any-hit (occlusion/shadow) query: True where some triangle blocks
    the ray within [tmin, tmax]. No closest-t race and no attribute fetch;
    a tile stops once all its rays are occluded."""
    R = rays.o.shape[0]
    tmax_eff, order, _, count, max_count = _cull(cs, rays, active, tile)
    T = R // tile
    F = _ray_features(rays.o, rays.d).reshape(T, tile, -1)
    tmin_t = rays.tmin.reshape(T, tile)[:, :, None]
    tmax_t = tmax_eff.reshape(T, tile)[:, :, None]
    occluded = torch.zeros((T, tile), dtype=torch.bool, device=rays.o.device)
    for k in range(max_count):
        live = (k < count) & (~occluded).any(dim=1)
        if k % _CHECK_EVERY == 0 and not bool(live.any()):
            break
        c_t = torch.where(live, order[:, k], 0)
        ad, u, v, t = _decode(F, cs, c_t)
        valid = ((ad > 0) & (u >= 0) & (v >= 0) & (u + v <= ad)
                 & (t > ad * tmin_t) & (t <= ad * tmax_t))
        occluded = occluded | (valid.any(dim=2) & live[:, None])
    return occluded.reshape(R)


def trace_mxu(cs, rays: Rays, env: Environment | None = None,
              active: torch.Tensor | None = None, tile: int = 512) -> MxuHits:
    """Closest hit of a wave on the plain cluster engine. R must be a
    multiple of ``tile``."""
    R = rays.o.shape[0]
    dev = rays.o.device
    tmax_eff, order, sorted_entry, count, max_count = _cull(cs, rays, active,
                                                            tile)
    T = R // tile
    C = cs.cluster_size
    F = _ray_features(rays.o, rays.d).reshape(T, tile, -1)
    I3 = cs.tri_id.reshape(-1, C)
    tmin_t = rays.tmin.reshape(T, tile)[:, :, None]

    best_t = tmax_eff.reshape(T, tile).clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_tri = torch.full((T, tile), INVALID_TRIANGLE, dtype=torch.int32,
                          device=dev)
    best_slot = torch.zeros((T, tile), dtype=torch.int32, device=dev)

    for k in range(max_count):
        # Front-to-back early-out: a tile is live while its k-th nearest
        # cluster can still beat some ray's current best.
        live = (k < count) & (sorted_entry[:, k] <= best_t.amax(dim=1))
        if k % _CHECK_EVERY == 0 and not bool(live.any()):
            break
        c_t = torch.where(live, order[:, k], 0)                  # (T,)
        ad, u, v, t = _decode(F, cs, c_t)
        valid = ((ad > 0) & (u >= 0) & (v >= 0) & (u + v <= ad)
                 & (t > ad * tmin_t) & (t < ad * best_t[:, :, None]))
        rcp_ad = 1.0 / torch.clamp_min(ad, 1e-30)
        tt = torch.where(valid, t * rcp_ad, INF)

        j = torch.argmin(tt, dim=2, keepdim=True)                # (T, tile, 1)
        tj = tt.gather(2, j)[:, :, 0]
        better = (tj < best_t) & live[:, None]
        j0 = j[:, :, 0]
        uj = (u * rcp_ad).gather(2, j)[:, :, 0]
        vj = (v * rcp_ad).gather(2, j)[:, :, 0]
        tri_j = I3[c_t].gather(1, j0)                            # (T, tile)
        slot_j = (c_t[:, None] * C + j0).to(torch.int32)         # attr row id

        best_t = torch.where(better, tj, best_t)
        best_u = torch.where(better, uj, best_u)
        best_v = torch.where(better, vj, best_v)
        best_tri = torch.where(better, tri_j, best_tri)
        best_slot = torch.where(better, slot_j, best_slot)

    tri = best_tri.reshape(R)
    attr = cs.attrs[best_slot.reshape(R).long()]
    hit = tri >= 0
    if env is not None:
        mask = hit if active is None else (hit | ~active)
        miss_rgb = torch.where(mask[:, None], 0.0,
                               sample_environment(env, rays.d))
    else:
        miss_rgb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    hits = Hits(tri=torch.where(hit, tri, INVALID_TRIANGLE),
                t=torch.where(hit, best_t.reshape(R), rays.tmax),
                u=best_u.reshape(R), v=best_v.reshape(R), miss_rgb=miss_rgb)
    return MxuHits(hits=hits, attrs=attr)
