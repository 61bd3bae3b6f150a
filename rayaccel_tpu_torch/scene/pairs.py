"""Shared-edge TrianglePair compilation.

Counterpart of ``rayaccel_tpu/scene/pairs.py``: within each BVH leaf,
triangles are greedily merged into pairs sharing an edge; unmatched
triangles become degenerate self-pairs whose second triangle has zero area
and can never be hit.

Pair geometry (consumed by ``ops/intersect.py:triangle_pair_intersect``):

    e1 = p0 - p1    (the shared edge)
    e2 = p2 - p0
    e3 = p3 - p0
    stored as rows [e1, e2, e3, p0]  -> (P, 12) float32

where, with tri0's shared edge starting at vertex slot ``edge0``:
    p0 = tri0[edge0], p1 = tri0[edge0+1], p2 = tri0[edge0+2],
    p3 = tri1[edge1+2]   (the vertex of tri1 opposite the shared edge).

The remap table stores, for each pair-triangle slot (2 per pair), the
original triangle id plus a 2-bit barycentric rotation code in the top
bits:

    code 0 or 3: (u, v) unchanged
    code 1:      (u, v) <- (1-u-v, u)
    code 2:      (u, v) <- (v, 1-u-v)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rayaccel_tpu_torch.scene.bvh import KIND_LEAF, Bvh2
from rayaccel_tpu_torch.scene.native.build import pair_all_native


@dataclasses.dataclass
class PairedScene:
    pairs: np.ndarray       # (P, 12) float32 [e1, e2, e3, p0]
    pair_tri: np.ndarray    # (2P,) uint32: orig tri | rotation_code << 30
    leaf_first: np.ndarray  # (N,) int64 pair range per BVH node (leaves only)
    leaf_last: np.ndarray   # (N,) int64


def _shared_edge(t0: np.ndarray, t1: np.ndarray):
    """Find (edge0, edge1) with t0[edge0] == t1[edge1+1] and
    t0[edge0+1] == t1[edge1], or None."""
    for e0 in range(3):
        a, b = t0[e0], t0[(e0 + 1) % 3]
        for e1 in range(3):
            if a == t1[(e1 + 1) % 3] and b == t1[e1]:
                return e0, e1
    return None


def _pair_row(p0, p1, p2, p3) -> np.ndarray:
    return np.concatenate([p0 - p1, p2 - p0, p3 - p0, p0]).astype(np.float32)


def build_pairs(bvh: Bvh2, vertices: np.ndarray, indices: np.ndarray,
                use_native: bool = True) -> PairedScene:
    """Pair triangles leaf by leaf and rewrite each leaf's primitive range
    to refer to pair indices. By default the native C++ pairing, which
    raises if it cannot be compiled; with ``use_native=False`` the Python
    pairing below, which the native one is held against."""
    if use_native:
        rows, remap, lf, ll = pair_all_native(vertices, indices, bvh)
        return PairedScene(pairs=rows, pair_tri=remap, leaf_first=lf,
                           leaf_last=ll)

    pairs, pair_tri = [], []
    n_nodes = bvh.node_count
    leaf_first = np.zeros(n_nodes, np.int64)
    leaf_last = np.zeros(n_nodes, np.int64)

    for node in range(n_nodes):
        if bvh.kind[node] != KIND_LEAF:
            continue
        cand = list(bvh.prim_order[bvh.first[node]:bvh.last[node]])
        leaf_first[node] = len(pairs)
        while cand:
            first = int(cand.pop(0))
            t0 = indices[first]
            match = None
            for ci, c in enumerate(cand):
                se = _shared_edge(t0, indices[int(c)])
                if se is not None:
                    match = (ci, int(c), se)
                    break
            if match is not None:
                ci, second, (e0, e1) = match
                cand.pop(ci)
                t1 = indices[second]
                v0 = vertices[t0]      # (3,3) rows = vertices of tri0
                p0 = v0[e0]
                p1 = v0[(e0 + 1) % 3]
                p2 = v0[(e0 + 2) % 3]
                p3 = vertices[t1[(e1 + 2) % 3]]
                pairs.append(_pair_row(p0, p1, p2, p3))
                pair_tri.append(np.uint32(first) | np.uint32(e0) << 30)
                pair_tri.append(np.uint32(second) | np.uint32(e1 + 1) << 30)
            else:
                # Degenerate self-pair: p3 = p1 makes
                # e3 = -e1, so triangle 2 has zero area and never hits.
                v = vertices[t0]
                pairs.append(_pair_row(v[0], v[1], v[2], v[1]))
                pair_tri.append(np.uint32(first))
                pair_tri.append(np.uint32(first))
        leaf_last[node] = len(pairs)

    return PairedScene(
        pairs=np.stack(pairs) if pairs else np.zeros((0, 12), np.float32),
        pair_tri=np.array(pair_tri, np.uint32),
        leaf_first=leaf_first,
        leaf_last=leaf_last,
    )


def unpack_rotation(pair_tri: np.ndarray):
    """Split remap entries into (triangle id, rotation code)."""
    tri = pair_tri & np.uint32(0x3FFFFFFF)
    code = pair_tri >> np.uint32(30)
    return tri.astype(np.int64), code.astype(np.int64)


def rotate_barycentrics(code, u, v):
    """Apply the rotation decode (vectorized, NumPy)."""
    w = 1.0 - u - v
    u_out = np.where(code == 1, w, np.where(code == 2, v, u))
    v_out = np.where(code == 1, u, np.where(code == 2, w, v))
    return u_out, v_out
