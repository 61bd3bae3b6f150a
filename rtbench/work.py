"""The work a trace layer's function needs, and the card's least time for it.

Adapted from ``chip_smoke.py``'s ``roofline`` and its pair counts, but
counted on the function and not on an implementation: for each active
ray a layer was given, the (ray, cluster) pairs whose box the ray enters
no later than its nearest hit (for a miss: its tmax), with the clusters
and the hit taken from the reference (``rtbench/reference/geometry.py``),
times the cluster's real triangles, times ``FLOP_PER_TRIANGLE``. Box tests
are not counted: a hierarchical walk needs fewer than a flat cull. Bytes
are each input read once (the active rays, every cluster box, the
triangle rows of the clusters some ray entered) and each output written
once, at the function's own record widths.

Peaks: one H100 SXM by NVIDIA's data sheet, dense, at 700 W: float32
outside the tensor cores and HBM3.
"""

from __future__ import annotations

import torch

from rtbench.reference import geometry as geom

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# 40 FMAs: the four bilinear dot products of one (ray, triangle) test.
FLOP_PER_TRIANGLE = 80
RAY_BYTES = 32            # o, d, tmin, tmax in float32
BOX_BYTES = 24            # bbmin, bbmax
TRIANGLE_BYTES = 36       # v0, e1, e2
# A closest hit's record (triangle id, t, u, v) and an occlusion flag.
OUTPUT_BYTES = {"closest": 16, "occlusion": 1}


def call_work(geo: geom.Geometry, o, d, tmin, tmax, active, kind: str):
    """(operations, bytes) of one call of a trace layer's function on rays
    (o, d, tmin, tmax) with the mask ``active`` (inactive lanes are no
    work)."""
    live = active & (tmax > 0)
    o, d, tmin, tmax = o[live], d[live], tmin[live], tmax[live]
    hit = geom.trace(geo, o, d, tmin, tmax)
    n = int(o.shape[0])
    flop = int(hit.pairs.sum()) * FLOP_PER_TRIANGLE
    moved = (n * (RAY_BYTES + OUTPUT_BYTES[kind])
             + geo.bbmin.shape[0] * BOX_BYTES
             + int(geo.cl_count[hit.touched].sum()) * TRIANGLE_BYTES)
    return flop, moved


def layer_work(geo: geom.Geometry, calls):
    """(operations, bytes) summed over a frame's calls of one layer:
    ``calls`` is a list of (o, d, tmin, tmax, active, kind)."""
    flop = moved = 0
    for c in calls:
        f, m = call_work(geo, *c)
        flop += f
        moved += m
    return flop, moved


def bound_ms(flop: int, moved: int) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(flop / PEAK_FP32_FLOPS, moved / PEAK_BYTES_PER_S) * 1e3


def bound_by(flop: int, moved: int) -> str:
    return ("operations" if flop / PEAK_FP32_FLOPS >= moved / PEAK_BYTES_PER_S
            else "bytes")


def captured(rays, active) -> tuple:
    """A copy of a layer call's rays and mask, off the program's tensors."""
    o, d, tmin, tmax = (torch.as_tensor(a).detach().clone() for a in rays)
    if active is None:
        active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    return o, d, tmin, tmax, active.detach().clone()
