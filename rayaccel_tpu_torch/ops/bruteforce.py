"""Brute-force reference intersector (test oracle).

Counterpart of ``rayaccel_tpu/ops/bruteforce.py``: an independent closest
hit over all triangles that every accelerated engine must agree with.
O(R * T): plain tensor arithmetic in chunks of triangles, on whatever
device the rays lie on.
"""

from __future__ import annotations

import math

import torch

from rayaccel_tpu_torch.ops.intersect import moller_trumbore
from rayaccel_tpu_torch.types import Hits, INVALID_TRIANGLE, Rays


def trace_bruteforce(tri_verts: torch.Tensor, rays: Rays,
                     chunk: int = 512) -> Hits:
    """Closest hit over all triangles. ``tri_verts``: (T, 3, 3).

    Ties on t are broken toward the lower triangle index, which matches a
    sequential first-wins scan with a strict ``t < best`` update."""
    T = tri_verts.shape[0]
    R = rays.o.shape[0]
    dev = rays.o.device
    best_t = torch.full((R,), math.inf, dtype=torch.float32, device=dev)
    best_tri = torch.full((R,), INVALID_TRIANGLE, dtype=torch.int32,
                          device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    o = rays.o[:, None, :]
    d = rays.d[:, None, :]
    for base in range(0, T, chunk):
        tc = tri_verts[base:base + chunk]
        valid, t, u, v = moller_trumbore(
            tc[None, :, 0], tc[None, :, 1], tc[None, :, 2], o, d,
            rays.tmin[:, None], rays.tmax[:, None])
        t = torch.where(valid, t, math.inf)
        j = torch.argmin(t, dim=1, keepdim=True)
        tj = t.gather(1, j)[:, 0]
        better = tj < best_t
        best_tri = torch.where(better, (base + j[:, 0]).to(torch.int32),
                               best_tri)
        best_u = torch.where(better, u.gather(1, j)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, j)[:, 0], best_v)
        best_t = torch.where(better, tj, best_t)

    miss = best_tri == INVALID_TRIANGLE
    return Hits(tri=best_tri, t=torch.where(miss, rays.tmax, best_t),
                u=best_u, v=best_v,
                miss_rgb=torch.zeros((R, 3), dtype=torch.float32,
                                     device=dev))
