"""Binary SAH BVH build (host side).

Counterpart of ``rayaccel_tpu/scene/bvh.py``: the ``Bvh2`` node arrays, a
``build_bvh`` that runs the repository's native C++ build
(``scene/native``) and, with ``use_native=False``, the NumPy golden build
the native one is held against: per-axis centroid-sorted orders, exact
full-sweep SAH with prefix/suffix area sweeps, a stable 3-axis partition,
cost constants traversal 2 / intersection 1, and a forced median split
whenever a would-be leaf exceeds 127 triangles (the device leaf encoding
packs the count into 8 bits). :func:`validate_bvh` checks the structural
invariants. The default never falls back: a native build that fails raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rayaccel_tpu_torch.scene.native import build_bvh_native

TRAVERSAL_COST = 2.0
INTERSECTION_COST = 1.0
MAX_LEAF_TRIS = 127

KIND_LEAF = 0
KIND_INTERIOR = 1


@dataclasses.dataclass
class Bvh2:
    """For interior nodes ``first``/``last`` are the child node indices; for
    leaves they are [start, end) into ``prim_order``."""

    kind: np.ndarray        # (N,) uint8
    first: np.ndarray       # (N,) int64
    last: np.ndarray        # (N,) int64
    parent: np.ndarray      # (N,) int64 (-1 for root)
    bbmin: np.ndarray       # (N, 3) float32
    bbmax: np.ndarray       # (N, 3) float32
    prim_order: np.ndarray  # (T,) int64 triangle ids in leaf-contiguous order

    @property
    def node_count(self) -> int:
        return len(self.kind)


def triangle_bounds(vertices: np.ndarray, indices: np.ndarray):
    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    bbmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    bbmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    return bbmin, bbmax


def _half_area(bbmin: np.ndarray, bbmax: np.ndarray) -> np.ndarray:
    d = np.maximum(bbmax - bbmin, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def build_bvh(vertices: np.ndarray, indices: np.ndarray,
              max_leaf: int = MAX_LEAF_TRIS, use_native: bool = True) -> Bvh2:
    """Full-sweep SAH build; ``max_leaf`` caps leaf size (<= 127). By
    default the native code, which raises if it cannot be compiled; with
    ``use_native=False`` the NumPy golden build below."""
    T = indices.shape[0]
    assert T >= 1
    max_leaf = min(max_leaf, MAX_LEAF_TRIS)

    if use_native:
        kind, first, last, parent, bbmin, bbmax, prim_order = \
            build_bvh_native(vertices, indices, max_leaf)
        return Bvh2(kind=kind, first=first, last=last, parent=parent,
                    bbmin=bbmin, bbmax=bbmax, prim_order=prim_order)

    tmin, tmax = triangle_bounds(vertices, indices)
    centroid = (tmin + tmax) * 0.5

    # Per-axis centroid orders; ties broken by index for determinism.
    orders = np.stack([np.argsort(centroid[:, a], kind="stable") for a in range(3)])

    node_kind, node_first, node_last = [], [], []
    node_parent, node_bbmin, node_bbmax = [], [], []

    def alloc(parent):
        node_kind.append(KIND_LEAF)
        node_first.append(0)
        node_last.append(0)
        node_parent.append(parent)
        node_bbmin.append(np.zeros(3, np.float32))
        node_bbmax.append(np.zeros(3, np.float32))
        return len(node_kind) - 1

    left_flag = np.zeros(T, bool)
    root = alloc(-1)
    # Work stack items: (node_id, start, end) — a shared [start, end) window
    # into all three order rows (each holds the same triangle set).
    stack = [(root, 0, T)]

    while stack:
        node, start, end = stack.pop()
        ids0 = orders[0, start:end]
        n = end - start

        bmin = tmin[ids0].min(axis=0)
        bmax = tmax[ids0].max(axis=0)
        node_bbmin[node] = bmin
        node_bbmax[node] = bmax

        make_leaf = n <= 1
        best = None  # (cost, axis, pivot)

        if not make_leaf:
            area_node = max(_half_area(bmin, bmax), 1e-30)
            leaf_cost = n * INTERSECTION_COST
            for axis in range(3):
                ids = orders[axis, start:end]
                lo, hi = tmin[ids], tmax[ids]
                # Prefix/suffix bound sweeps.
                pre_min = np.minimum.accumulate(lo, axis=0)
                pre_max = np.maximum.accumulate(hi, axis=0)
                suf_min = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
                suf_max = np.maximum.accumulate(hi[::-1], axis=0)[::-1]
                counts = np.arange(1, n, dtype=np.float64)
                a_l = _half_area(pre_min[:-1], pre_max[:-1])
                a_r = _half_area(suf_min[1:], suf_max[1:])
                cost = a_l * counts + a_r * (n - counts)
                i = int(np.argmin(cost))
                c = float(cost[i])
                if best is None or c < best[0]:
                    best = (c, axis, i + 1)

            split_cost = TRAVERSAL_COST + best[0] / area_node * INTERSECTION_COST
            if split_cost >= leaf_cost and n <= max_leaf:
                make_leaf = True

        if make_leaf and n > max_leaf:
            # Forced median split on the largest axis.
            axis = int(np.argmax(bmax - bmin))
            best = (0.0, axis, n // 2)
            make_leaf = False

        if make_leaf:
            node_kind[node] = KIND_LEAF
            node_first[node] = start
            node_last[node] = end
            continue

        _, axis, pivot = best
        left_ids = orders[axis, start:start + pivot]
        left_flag[left_ids] = True
        # Stable partition of the other two axis orders.
        for other in range(3):
            if other == axis:
                continue
            seg = orders[other, start:end]
            flags = left_flag[seg]
            orders[other, start:end] = np.concatenate([seg[flags], seg[~flags]])
        left_flag[left_ids] = False

        lchild = alloc(node)
        rchild = alloc(node)
        node_kind[node] = KIND_INTERIOR
        node_first[node] = lchild
        node_last[node] = rchild
        stack.append((rchild, start + pivot, end))
        stack.append((lchild, start, start + pivot))

    return Bvh2(
        kind=np.array(node_kind, np.uint8),
        first=np.array(node_first, np.int64),
        last=np.array(node_last, np.int64),
        parent=np.array(node_parent, np.int64),
        bbmin=np.stack(node_bbmin),
        bbmax=np.stack(node_bbmax),
        prim_order=orders[0].copy(),
    )



def validate_bvh(bvh: Bvh2, tri_bbmin: np.ndarray, tri_bbmax: np.ndarray) -> None:
    """Structural invariants: every triangle appears in exactly one leaf; node bounds contain their
    contents; interior children point back at their parent."""
    T = len(bvh.prim_order)
    seen = np.zeros(T, np.int64)
    for i in range(bvh.node_count):
        if bvh.kind[i] == KIND_LEAF:
            ids = bvh.prim_order[bvh.first[i]:bvh.last[i]]
            seen[ids] += 1
            assert len(ids) <= MAX_LEAF_TRIS, "leaf too large"
            assert np.all(tri_bbmin[ids] >= bvh.bbmin[i][None] - 1e-4)
            assert np.all(tri_bbmax[ids] <= bvh.bbmax[i][None] + 1e-4)
        else:
            l, r = bvh.first[i], bvh.last[i]
            assert bvh.parent[l] == i and bvh.parent[r] == i
            for c in (l, r):
                assert np.all(bvh.bbmin[c] >= bvh.bbmin[i] - 1e-4)
                assert np.all(bvh.bbmax[c] <= bvh.bbmax[i] + 1e-4)
    assert np.all(seen == 1), "every triangle must be in exactly one leaf"
