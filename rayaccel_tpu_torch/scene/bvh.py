"""Binary SAH BVH (host side).

Counterpart of ``rayaccel_tpu/scene/bvh.py``: the ``Bvh2`` node arrays and
a ``build_bvh`` that runs the repository's native C++ builder
(``scene/native``). The NumPy golden builder is ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rayaccel_tpu_torch.scene.native import build_bvh_native

MAX_LEAF_TRIS = 127

KIND_LEAF = 0


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


def build_bvh(vertices: np.ndarray, indices: np.ndarray,
              max_leaf: int = MAX_LEAF_TRIS) -> Bvh2:
    """Full-sweep SAH build by the native builder. Raises if it cannot be
    compiled."""
    assert indices.shape[0] >= 1
    kind, first, last, parent, bbmin, bbmax, prim_order = build_bvh_native(
        vertices, indices, min(max_leaf, MAX_LEAF_TRIS))
    return Bvh2(kind=kind, first=first, last=last, parent=parent,
                bbmin=bbmin, bbmax=bbmax, prim_order=prim_order)
