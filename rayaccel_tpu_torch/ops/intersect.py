"""Vectorized intersection primitives.

Counterpart of ``rayaccel_tpu/ops/intersect.py``: ``safe_inv_dir``, the
slab tests ``aabb_hit`` / ``aabb_hit_soa``, the shared-edge TrianglePair
test ``triangle_pair_intersect`` / ``triangle_pair_intersect_soa`` with its
``PairHit`` result, ``rotate_barycentrics`` and the single-triangle
``moller_trumbore`` of the brute-force oracle; plus the row-wise 3-vector
products every module shares. Those are written out, summed left to right,
so a row rounds the same way wherever it sits in a batch (a reduction
kernel may regroup a sum by position).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DIR_EPSILON = 1e-10  # direction component clamp, Kernels.h:149-157


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with tiny components clamped away from zero, preserving sign."""
    small = torch.abs(d) < DIR_EPSILON
    clamp = torch.where(d < 0, -DIR_EPSILON, DIR_EPSILON).to(d.dtype)
    return 1.0 / torch.where(small, clamp, d)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of (R, 3) tensors."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product of (R, 3) tensors."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by,
            az * bx - ax * bz,
            ax * by - ay * bx)


def aabb_hit(bbmin, bbmax, inv_d, ood, tmin, tmax):
    """Slab test. ``bbmin``/``bbmax``: (..., 3); ``inv_d``/``ood``: (..., 3)
    with ``ood = -origin * inv_d``. Returns (hit, t_enter): hit where the
    [tmin, tmax] interval overlaps the box; t_enter is the clamped entry
    distance used for near-child ordering."""
    t_near = bbmin * inv_d + ood
    t_far = bbmax * inv_d + ood
    lo = torch.minimum(t_near, t_far)
    hi = torch.maximum(t_near, t_far)
    t0 = torch.maximum(lo.amax(dim=-1), tmin)
    t1 = torch.minimum(hi.amin(dim=-1), tmax)
    return t0 <= t1, t0


def aabb_hit_soa(bmin, bmax, inv_d, ood, tmin, tmax):
    """Component-wise slab test: ``bmin``, ``bmax``, ``inv_d`` and ``ood``
    are tuples of three (R,) tensors, ``tmin`` / ``tmax`` (R,) tensors."""
    t0 = tmin
    t1 = tmax
    for a in range(3):
        tn = bmin[a] * inv_d[a] + ood[a]
        tf = bmax[a] * inv_d[a] + ood[a]
        t0 = torch.maximum(t0, torch.minimum(tn, tf))
        t1 = torch.minimum(t1, torch.maximum(tn, tf))
    return t0 <= t1, t0


class PairHit(NamedTuple):
    valid: torch.Tensor  # (...,) bool: hit either triangle of the pair
    which: torch.Tensor  # (...,) int32: 0/1, which pair triangle
    t: torch.Tensor      # (...,) float32
    u: torch.Tensor      # (...,) float32 (pair-local barycentric)
    v: torch.Tensor      # (...,) float32


def triangle_pair_intersect(pair_row, o, d, tmin, tmax) -> PairHit:
    """Intersect rays with triangle pairs (row layout [e1, e2, e3, p0, ...]).
    All inputs broadcast over the leading batch shape; ``pair_row`` is
    (..., >= 12)."""
    cols = tuple(pair_row[..., k] for k in range(12))
    oc = (o[..., 0], o[..., 1], o[..., 2])
    dc = (d[..., 0], d[..., 1], d[..., 2])
    return triangle_pair_intersect_soa(cols, oc, dc, tmin, tmax)


def triangle_pair_intersect_soa(cols, o, d, tmin, tmax) -> PairHit:
    """Component-wise TrianglePair test: triangle 1 = (p0, p0 - e1 side,
    p0 + e2), triangle 2 = (p0, p0 + e3, p0 - e1 side); both share the
    cross products built from e1. ``cols``: 12 tensors [e1xyz, e2xyz,
    e3xyz, p0xyz]; ``o`` / ``d``: tuples of three tensors."""
    (e1x, e1y, e1z, e2x, e2y, e2z,
     e3x, e3y, e3z, p0x, p0y, p0z) = cols
    ox, oy, oz = o
    dx, dy, dz = d

    n1x, n1y, n1z = _cross(e1x, e1y, e1z, e2x, e2y, e2z)
    n2x, n2y, n2z = _cross(e3x, e3y, e3z, e1x, e1y, e1z)

    cx, cy, cz = p0x - ox, p0y - oy, p0z - oz
    rx, ry, rz = _cross(dx, dy, dz, cx, cy, cz)

    det1 = n1x * dx + n1y * dy + n1z * dz
    det2 = n2x * dx + n2y * dy + n2z * dz
    s1 = torch.where(det1 < 0, -1.0, 1.0)
    s2 = torch.where(det2 < 0, -1.0, 1.0)

    r_e1 = rx * e1x + ry * e1y + rz * e1z
    r_e2 = rx * e2x + ry * e2y + rz * e2z
    r_e3 = rx * e3x + ry * e3y + rz * e3z

    u1 = r_e2 * s1
    v1 = r_e1 * s1
    u2 = -r_e1 * s2
    v2 = -r_e3 * s2

    abs_det1 = torch.abs(det1)
    abs_det2 = torch.abs(det2)
    w1 = abs_det1 - u1 - v1
    w2 = abs_det2 - u2 - v2

    t1 = (n1x * cx + n1y * cy + n1z * cz) * s1
    t2 = (n2x * cx + n2y * cy + n2z * cz) * s2

    ok1 = ((u1 >= 0) & (v1 >= 0) & (w1 >= 0)
           & (t1 > abs_det1 * tmin) & (t1 <= abs_det1 * tmax))
    ok2 = ((u2 >= 0) & (v2 >= 0) & (w2 >= 0)
           & (t2 > abs_det2 * tmin) & (t2 <= abs_det2 * tmax))

    # Triangle 2 wins when it is the only hit, or both hit and it is nearer.
    pick2 = (ok2 & ~ok1) | (ok1 & ok2 & (t1 * abs_det2 > t2 * abs_det1))

    abs_det = torch.where(pick2, abs_det2, abs_det1)
    tt = torch.where(pick2, t2, t1)
    uu = torch.where(pick2, u2, u1)
    vv = torch.where(pick2, v2, v1)

    rcp = 1.0 / torch.where(abs_det == 0, 1.0, abs_det)
    return PairHit(valid=ok1 | ok2, which=pick2.to(torch.int32),
                   t=tt * rcp, u=uu * rcp, v=vv * rcp)


def rotate_barycentrics(code, u, v):
    """Un-rotate pair-local barycentrics to the original vertex order.
    code 0/3: identity; 1: (u, v) <- (w, u); 2: (u, v) <- (v, w)."""
    w = 1.0 - u - v
    u_out = torch.where(code == 1, w, torch.where(code == 2, v, u))
    v_out = torch.where(code == 1, u, torch.where(code == 2, w, v))
    return u_out, v_out


def moller_trumbore(v0, v1, v2, o, d, tmin, tmax):
    """Classic single-triangle test (u toward v1, v toward v2) used by the
    brute-force oracle. Shapes broadcast; the last dimension is xyz."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = torch.linalg.cross(*torch.broadcast_tensors(d, e2), dim=-1)
    det = (p * e1).sum(dim=-1)
    inv = 1.0 / torch.where(det == 0, 1.0, det)
    tvec = o - v0
    u = (p * tvec).sum(dim=-1) * inv
    q = torch.linalg.cross(*torch.broadcast_tensors(tvec, e1), dim=-1)
    v = (q * d).sum(dim=-1) * inv
    t = (q * e2).sum(dim=-1) * inv
    valid = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t > tmin) & (t <= tmax))
    return valid, t, u, v
