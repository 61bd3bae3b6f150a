"""Shared shading geometry: the surface frame from a hit's attribute row,
and the spawn rules for secondary rays.

Counterpart of ``rayaccel_tpu/render/shading.py`` (``interpolate_surface``
``:45-74``, ``surface_from_attrs`` ``:77-133``, ``spawn_secondary`` and
``merge_rays`` ``:136-179``, and the constants ``:29-33``). Normals are
stored outward, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayaccel_tpu_torch.ops.intersect import cross3, dot3
from rayaccel_tpu_torch.scene.clusters import (ATTR_GEOM_COL, ATTR_PACK_COLS,
                                               ATTR_UV_COL)
from rayaccel_tpu_torch.types import Hits, Rays

WEIGHT_CUTOFF = 0.01        # PathTracingRenderer.cpp:394, WhittedRenderer.cpp:407
ORIGIN_EPSILON = 1e-4       # PathTracingRenderer.cpp:410-412
SECONDARY_TMIN = 1e-3       # PathTracingRenderer.cpp:421
SECONDARY_TMAX = 1e6


class SurfaceSample(NamedTuple):
    pos: torch.Tensor         # (R, 3) hit position (o + t*d)
    ns: torch.Tensor          # (R, 3) shading normal, flipped toward the ray
    ng: torch.Tensor          # (R, 3) geometric normal (outward, unflipped)
    uv: torch.Tensor          # (R, 2) interpolated texcoords
    mat_params: torch.Tensor  # (R, 4) material parameters
    d_dot_ng: torch.Tensor    # (R,) sign carrier for side tests
    entering: torch.Tensor    # (R,) bool: ray hits the outward-facing side


def _unpack_bf16_pairs(words: torch.Tensor):
    """f32 words holding (bf16 hi << 16 | bf16 lo) -> (hi, lo) float32: a
    bf16 is the top half of an f32, so each half is a mask or a shift."""
    pk = words.contiguous().view(torch.int32)
    hi = (pk & -0x10000).view(torch.float32)
    lo = (pk << 16).view(torch.float32)
    return hi, lo


def interpolate_surface(scene, rays: Rays, hits: Hits,
                        active: torch.Tensor) -> SurfaceSample:
    """Gather per-triangle and per-vertex attributes of a
    ``scene/compile.py:TpuScene`` and build the shading frame (the lockstep
    BVH engine's path): texcoord and normal interpolation with weights
    (1-u-v, u, v), normalization, two-sided flip."""
    tri = torch.where(active, hits.tri, 0).long()
    idx3 = scene.tri_index[tri].long()                     # (R, 3)
    vn = scene.vert_normal[idx3]                           # (R, 3, 3)
    vt = scene.vert_uv[idx3]                               # (R, 3, 2)

    u = hits.u[:, None]
    v = hits.v[:, None]
    w = 1.0 - u - v
    ns = vn[:, 0] * w + vn[:, 1] * u + vn[:, 2] * v
    ns = ns * torch.rsqrt(dot3(ns, ns))[:, None]
    uv = vt[:, 0] * w + vt[:, 1] * u + vt[:, 2] * v

    ng = scene.tri_normal[tri]
    params = scene.mat_params[scene.tri_mat[tri].long()]

    d_dot_ng = dot3(rays.d, ng)
    entering = d_dot_ng < 0
    # Two-sided flip toward the incoming ray (outward-normal convention).
    ns = torch.where(entering[:, None], ns, -ns)
    pos = rays.o + hits.t[:, None] * rays.d
    return SurfaceSample(pos=pos, ns=ns, ng=ng, uv=uv, mat_params=params,
                         d_dot_ng=d_dot_ng, entering=entering)


def surface_from_attrs(attrs: torch.Tensor, mat_table: torch.Tensor,
                       rays: Rays, hits: Hits) -> SurfaceSample:
    """Build the shading frame from the tracer's per-hit attribute rows
    (``scene/clusters.py`` layout)."""
    u = hits.u[:, None]
    v = hits.v[:, None]
    w = 1.0 - u - v
    hi, lo = _unpack_bf16_pairs(attrs[:, :ATTR_PACK_COLS])
    n0 = torch.stack([hi[:, 0], lo[:, 0], hi[:, 1]], dim=-1)
    n1 = torch.stack([lo[:, 1], hi[:, 2], lo[:, 2]], dim=-1)
    n2 = torch.stack([hi[:, 3], lo[:, 3], hi[:, 4]], dim=-1)
    ns = n0 * w + n1 * u + n2 * v
    ns = ns * torch.rsqrt(torch.clamp_min(dot3(ns, ns), 1e-30))[:, None]
    # Geometric normal from the exact stored edges (same winding and
    # formula as scene/data.py compute_face_normals).
    e1 = attrs[:, ATTR_GEOM_COL + 3:ATTR_GEOM_COL + 6]
    e2 = attrs[:, ATTR_GEOM_COL + 6:ATTR_GEOM_COL + 9]
    ng = cross3(e1, e2)
    ng = ng * torch.rsqrt(torch.clamp_min(dot3(ng, ng), 1e-30))[:, None]
    uhi, ulo = _unpack_bf16_pairs(attrs[:, ATTR_UV_COL:ATTR_UV_COL + 3])
    uv = torch.cat([uhi[:, 0:1] * w + uhi[:, 1:2] * u + uhi[:, 2:3] * v,
                    ulo[:, 0:1] * w + ulo[:, 1:2] * u + ulo[:, 2:3] * v],
                   dim=-1)
    # Material id: the low half of the fifth word (a small-integer float).
    params = mat_table[lo[:, 4].to(torch.int64)]

    d_dot_ng = dot3(rays.d, ng)
    entering = d_dot_ng < 0
    ns = torch.where(entering[:, None], ns, -ns)
    pos = rays.o + hits.t[:, None] * rays.d
    return SurfaceSample(pos=pos, ns=ns, ng=ng, uv=uv, mat_params=params,
                         d_dot_ng=d_dot_ng, entering=entering)


def spawn_secondary(surf: SurfaceSample, wi: torch.Tensor,
                    new_weight: torch.Tensor, transmitted: torch.Tensor,
                    d_dot_ng: torch.Tensor):
    """Secondary-ray validation + construction: weight cutoff, side
    consistency, NaN kill, 1e-4 origin offset along Ng, tmin/tmax =
    1e-3 / 1e6. Returns (rays, ok)."""
    wi_dot_ng = dot3(wi, surf.ng)
    opposite = (wi_dot_ng > 0) != (d_dot_ng > 0)
    ok_side = opposite != transmitted

    ok_weight = torch.any(new_weight > WEIGHT_CUTOFF, dim=-1)

    offset_sign = torch.where(wi_dot_ng >= 0, 1.0, -1.0)
    pos = surf.pos + surf.ng * (ORIGIN_EPSILON * offset_sign)[:, None]

    finite = (torch.all(torch.isfinite(pos), dim=-1)
              & torch.all(torch.isfinite(wi), dim=-1))

    return secondary_rays(pos, wi), ok_weight & ok_side & finite


def secondary_rays(o: torch.Tensor, d: torch.Tensor) -> Rays:
    """Rays from ``o`` along ``d`` over [SECONDARY_TMIN, SECONDARY_TMAX]."""
    n = o.shape[0]
    return Rays(o, d,
                torch.full((n,), SECONDARY_TMIN, dtype=torch.float32,
                           device=o.device),
                torch.full((n,), SECONDARY_TMAX, dtype=torch.float32,
                           device=o.device))


def merge_rays(cond: torch.Tensor, a: Rays, b: Rays) -> Rays:
    c = cond[:, None]
    return Rays(
        o=torch.where(c, a.o, b.o),
        d=torch.where(c, a.d, b.d),
        tmin=torch.where(cond, a.tmin, b.tmin),
        tmax=torch.where(cond, a.tmax, b.tmax),
    )
