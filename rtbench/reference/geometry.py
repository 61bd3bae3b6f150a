"""The reference's geometry: the triangles of the scene, its own clusters,
and a plain closest-hit trace.

The clusters are the yardstick's, not the program's: triangles sorted by
the Morton code of their centroid (10 bits an axis) and cut into runs of
``CLUSTER`` (the last one shorter), each with its bounding box. They speed
the trace up and define the work that ``rtbench/work.py`` counts; any
grouping gives the same nearest hits.

The trace is Moller-Trumbore in float32 over [v0, e1 = v1 - v0,
e2 = v2 - v0], every cluster whose box a ray enters before its best hit
so far, nearest box first. A hit needs det != 0, u >= 0, v >= 0,
u + v <= 1 and tmin < t <= tmax; of equal t the first found wins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CLUSTER = 128
INF = float("inf")
DIR_EPSILON = 1e-10
# Rays a trace call works on at once: at most CHUNK, and so few that a
# chunk's (rays, clusters) float32 slab entries stay within ENTRY_BYTES (the
# sort, the mask and the counts beside them take a few times that).
CHUNK = 65536
ENTRY_BYTES = 1 << 29


class Geometry(NamedTuple):
    v0: torch.Tensor        # (T, 3) float32
    e1: torch.Tensor        # (T, 3)
    e2: torch.Tensor        # (T, 3)
    normals: torch.Tensor   # (T, 3, 3) vertex normals, rounded to bf16
    material: torch.Tensor  # (T,) int64
    materials: torch.Tensor  # (M, 4) [kr, kg, kb, eta]
    cl_tris: torch.Tensor   # (n_c, CLUSTER) int64 triangle ids, -1 padding
    cl_count: torch.Tensor  # (n_c,) int64 real triangles
    bbmin: torch.Tensor     # (n_c, 3)
    bbmax: torch.Tensor     # (n_c, 3)


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in [0, 1)^3."""
    q = np.clip((c * 1024).astype(np.int64), 0, 1023)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def build(scene: dict, device) -> Geometry:
    """The geometry of a scene's arrays (``rtbench/scene.py``'s fields).
    The vertex normals are rounded to bf16 (nearest even), as the
    program's scene format stores its shading normals; everything else is
    the scene's float32."""
    v = np.asarray(scene["vertices"], np.float32)
    idx = np.asarray(scene["indices"], np.int64)
    p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
    cent = (p0 + p1 + p2) / 3.0
    lo, hi = cent.min(0), cent.max(0)
    order = np.argsort(_morton((cent - lo) / np.maximum(hi - lo, 1e-20)),
                       kind="stable")
    T = len(idx)
    n_c = -(-T // CLUSTER)
    cl_tris = np.full(n_c * CLUSTER, -1, np.int64)
    cl_tris[:T] = order
    cl_tris = cl_tris.reshape(n_c, CLUSTER)
    real = cl_tris >= 0
    corners = np.stack([p0, p1, p2], axis=1)[np.where(real, cl_tris, 0)]
    big = np.float32(3e38)
    bbmin = np.where(real[..., None, None], corners, big).min(axis=(1, 2))
    bbmax = np.where(real[..., None, None], corners, -big).max(axis=(1, 2))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    vn = t(np.asarray(scene["normals"], np.float32)[idx])   # (T, 3, 3)
    return Geometry(
        v0=t(p0), e1=t(p1 - p0), e2=t(p2 - p0),
        normals=vn.to(torch.bfloat16).to(torch.float32),
        material=t(np.asarray(scene["triangle_materials"], np.int64),
                   torch.int64),
        materials=t(scene["materials"]),
        cl_tris=t(cl_tris, torch.int64), cl_count=t(real.sum(1), torch.int64),
        bbmin=t(bbmin), bbmax=t(bbmax))


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def box_entries(geo: Geometry, o, d, tmin, tmax):
    """(R, n_c) distance at which each ray enters each cluster's box within
    [tmin, tmax], ``INF`` where it does not."""
    small = d.abs() < DIR_EPSILON
    inv = 1.0 / torch.where(small, torch.where(d < 0, -DIR_EPSILON,
                                               DIR_EPSILON), d)
    t0 = tmin[:, None].expand(-1, geo.bbmin.shape[0])
    t1 = tmax[:, None].expand(-1, geo.bbmin.shape[0])
    for a in range(3):
        tn = (geo.bbmin[None, :, a] - o[:, a, None]) * inv[:, a, None]
        tf = (geo.bbmax[None, :, a] - o[:, a, None]) * inv[:, a, None]
        t0 = torch.maximum(t0, torch.minimum(tn, tf))
        t1 = torch.minimum(t1, torch.maximum(tn, tf))
    return torch.where(t0 <= t1, t0, torch.full_like(t0, INF))


def intersect(geo: Geometry, o, d, tris):
    """Moller-Trumbore of rays (n, 3) against triangle ids (n, k):
    (det != 0 and inside, t, u, v), each (n, k)."""
    safe = tris.clamp_min(0)
    v0, e1, e2 = geo.v0[safe], geo.e1[safe], geo.e2[safe]
    dd = d[:, None, :].expand_as(e2)
    pvec = cross(dd, e2)
    det = dot(pvec, e1)
    inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tvec = o[:, None, :] - v0
    u = dot(pvec, tvec) * inv
    qvec = cross(tvec, e1)
    v = dot(qvec, dd) * inv
    t = dot(qvec, e2) * inv
    ok = (tris >= 0) & (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
    return ok, t, u, v


class TraceResult(NamedTuple):
    tri: torch.Tensor     # (R,) int64, -1 on a miss
    t: torch.Tensor       # (R,) float32, tmax on a miss
    u: torch.Tensor
    v: torch.Tensor
    pairs: torch.Tensor   # (R,) int64: triangles of the clusters entered
                          # no later than t
    touched: torch.Tensor  # (n_c,) bool: clusters some ray entered by t


def chunk_rays(n_clusters: int) -> int:
    """Rays a chunk: ``CHUNK``, or fewer where their entries would pass
    ``ENTRY_BYTES``."""
    return max(1, min(CHUNK, ENTRY_BYTES // (4 * max(1, n_clusters))))


def trace(geo: Geometry, o, d, tmin, tmax,
          chunk: int | None = None) -> TraceResult:
    """Closest hit of every ray in [tmin, tmax], in chunks of ``chunk``
    rays (default: ``chunk_rays`` of the cluster count). A ray's result
    does not depend on its chunk."""
    chunk = chunk or chunk_rays(geo.bbmin.shape[0])
    parts = [_trace_chunk(geo, o[s:s + chunk], d[s:s + chunk],
                          tmin[s:s + chunk], tmax[s:s + chunk])
             for s in range(0, o.shape[0], chunk)]
    if not parts:
        z = torch.zeros((0,), device=o.device)
        return TraceResult(z.long(), z, z, z, z.long(),
                           torch.zeros(geo.bbmin.shape[0], dtype=torch.bool,
                                       device=o.device))
    touched = torch.stack([p.touched for p in parts]).any(0)
    return TraceResult(*(torch.cat([getattr(p, f) for p in parts])
                         for f in TraceResult._fields[:-1]), touched)


def _trace_chunk(geo, o, d, tmin, tmax) -> TraceResult:
    R = o.shape[0]
    entry = box_entries(geo, o, d, tmin, tmax)
    se, order = torch.sort(entry, dim=1, stable=True)
    best = tmax.clone()
    tri = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)
    for k in range(se.shape[1]):
        rows = (se[:, k] <= best).nonzero().squeeze(1)
        if rows.numel() == 0:
            break
        cand = geo.cl_tris[order[rows, k]]                  # (n, CLUSTER)
        ok, t, u, v = intersect(geo, o[rows], d[rows], cand)
        ok &= (t > tmin[rows, None]) & (t <= best[rows, None])
        t = torch.where(ok, t, torch.full_like(t, INF))
        tb, j = t.min(dim=1)
        better = tb < best[rows]
        r = rows[better]
        jj = j[better][:, None]
        best[r] = tb[better]
        tri[r] = cand[better].gather(1, jj).squeeze(1)
        bu[r] = u[better].gather(1, jj).squeeze(1)
        bv[r] = v[better].gather(1, jj).squeeze(1)
    within = entry <= best[:, None]
    pairs = (within.long() * geo.cl_count[None, :]).sum(1)
    return TraceResult(tri, best, bu, bv, pairs, within.any(0))
