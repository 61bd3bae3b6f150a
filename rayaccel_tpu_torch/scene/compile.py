"""Scene compiler: host geometry -> device-resident traversal structures.

Counterpart of ``rayaccel_tpu/scene/compile.py``: build the BVH, pair leaf
triangles, translate to the 2-wide node format, and move the arrays onto a
device. The compile is NumPy and produces the same arrays as the JAX
package, bit for bit; :func:`tpu_scene_from_numpy` moves them.

Device layout:

``nodes`` - (N, 16) float32, one 64-byte row per *interior* node so a
traversal step costs exactly one row gather:
    [0:3]  child0 bbmin     [3:6]  child0 bbmax
    [6:9]  child1 bbmin     [9:12] child1 bbmax
    [12]   child0 ref (int32 bit pattern)
    [13]   child1 ref (int32 bit pattern)
    [14:16] zero padding
A ref >= 0 is an interior node index; a ref < 0 encodes a leaf:
``enc = first_pair | (pair_count << 24); ref = -enc - 1``.

``pairs`` - (P, 16) float32: [e1, e2, e3, p0, pad*4].

``pair_tri`` - (2P,) int32: original triangle | rotation_code << 30.

Shading attributes are separate arrays gathered per hit; the oracle
triangle soup ``tri_verts`` backs the brute-force reference intersector.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.scene.bvh import KIND_LEAF, Bvh2, build_bvh
from rayaccel_tpu_torch.scene.data import (SceneData, compute_face_normals,
                                           compute_vertex_normals)
from rayaccel_tpu_torch.scene.pairs import PairedScene, build_pairs

LEAF_COUNT_SHIFT = 24
LEAF_FIRST_MASK = (1 << 24) - 1


def encode_leaf(first: int, count: int) -> int:
    # first+count must fit the mask so the traversal cursor (first+1 each
    # step) never carries into the count bits (ops/trace.py leaf step).
    assert (0 <= first and 0 <= count < 256
            and first + count <= LEAF_FIRST_MASK)
    return -(first | (count << LEAF_COUNT_SHIFT)) - 1


class TpuScene(NamedTuple):
    """Device-resident compiled scene of the lockstep BVH engine (the name
    is the JAX package's; every field is a tensor on one device)."""

    nodes: torch.Tensor        # (N, 16) float32
    pairs: torch.Tensor        # (P, 16) float32
    pair_tri: torch.Tensor     # (2P,) int32
    tri_index: torch.Tensor    # (T, 3) int32
    tri_normal: torch.Tensor   # (T, 3) float32
    tri_mat: torch.Tensor      # (T,) int32
    vert_normal: torch.Tensor  # (V, 3) float32
    vert_uv: torch.Tensor      # (V, 2) float32
    mat_params: torch.Tensor   # (M, 4) float32
    tri_verts: torch.Tensor    # (T, 3, 3) float32 oracle triangle soup

    @property
    def triangle_count(self) -> int:
        return self.tri_index.shape[0]

    @property
    def node_count(self) -> int:
        return self.nodes.shape[0]

    @property
    def pair_count(self) -> int:
        return self.pairs.shape[0]


_INT_FIELDS = ("pair_tri", "tri_index", "tri_mat")


def _collapse_nodes(bvh: Bvh2, paired: PairedScene) -> np.ndarray:
    """Translate the BVH2 into 2-wide interior rows."""
    n_nodes = bvh.node_count
    interior = np.flatnonzero(bvh.kind != KIND_LEAF)

    if len(interior) == 0:
        # Single-leaf scene: synthesize one interior whose second child is
        # an empty leaf.
        row = np.zeros(16, np.float32)
        row[0:3] = bvh.bbmin[0]
        row[3:6] = bvh.bbmax[0]
        row[6:9] = np.float32(np.inf)
        row[9:12] = np.float32(-np.inf)
        refs = np.array([
            encode_leaf(int(paired.leaf_first[0]),
                        int(paired.leaf_last[0] - paired.leaf_first[0])),
            encode_leaf(0, 0),
        ], np.int32)
        row[12:14] = refs.view(np.float32)
        return row[None, :]

    remap = np.full(n_nodes, -1, np.int64)
    remap[interior] = np.arange(len(interior))

    def child_ref(c: int) -> np.int32:
        if bvh.kind[c] == KIND_LEAF:
            first = int(paired.leaf_first[c])
            count = int(paired.leaf_last[c] - paired.leaf_first[c])
            return np.int32(encode_leaf(first, count))
        return np.int32(remap[c])

    rows = np.zeros((len(interior), 16), np.float32)
    refs = np.zeros((len(interior), 2), np.int32)
    for out_i, i in enumerate(interior):
        l, r = int(bvh.first[i]), int(bvh.last[i])
        rows[out_i, 0:3] = bvh.bbmin[l]
        rows[out_i, 3:6] = bvh.bbmax[l]
        rows[out_i, 6:9] = bvh.bbmin[r]
        rows[out_i, 9:12] = bvh.bbmax[r]
        refs[out_i, 0] = child_ref(l)
        refs[out_i, 1] = child_ref(r)
    rows[:, 12:14] = refs.view(np.float32)
    return rows


def compile_scene_np(scene: SceneData, max_leaf: int = 64) -> dict:
    """The NumPy scene compile: a dict of the ``TpuScene`` arrays."""
    verts = np.asarray(scene.vertices, np.float32)
    idx = np.asarray(scene.indices, np.int64)

    bvh = build_bvh(verts, idx, max_leaf=max_leaf)
    paired = build_pairs(bvh, verts, idx)
    nodes = _collapse_nodes(bvh, paired)

    pairs16 = np.zeros((max(paired.pairs.shape[0], 1), 16), np.float32)
    pairs16[:paired.pairs.shape[0], :12] = paired.pairs

    pair_tri = paired.pair_tri.view(np.int32)
    if pair_tri.size == 0:
        pair_tri = np.zeros(2, np.int32)

    return dict(
        nodes=nodes, pairs=pairs16, pair_tri=pair_tri,
        tri_index=idx.astype(np.int32),
        tri_normal=np.asarray(scene.triangle_normals, np.float32),
        tri_mat=np.asarray(scene.triangle_materials).astype(np.int32),
        vert_normal=np.asarray(scene.normals, np.float32),
        vert_uv=np.asarray(scene.texcoords, np.float32),
        mat_params=np.asarray(scene.materials, np.float32),
        tri_verts=verts[idx])                                   # (T, 3, 3)


def tpu_scene_from_numpy(nodes, pairs, pair_tri, tri_index, tri_normal,
                         tri_mat, vert_normal, vert_uv, mat_params, tri_verts,
                         device=None) -> TpuScene:
    """Move compiled scene arrays onto ``device`` (``device.py:
    resolve_device``: default the current CUDA device). Takes the JAX
    package's ``TpuScene`` fields as well (``np.asarray`` of each), so both
    packages can trace one scene."""
    device = resolve_device(device)
    arrays = dict(nodes=nodes, pairs=pairs, pair_tri=pair_tri,
                  tri_index=tri_index, tri_normal=tri_normal, tri_mat=tri_mat,
                  vert_normal=vert_normal, vert_uv=vert_uv,
                  mat_params=mat_params, tri_verts=tri_verts)
    return TpuScene(**{
        name: torch.tensor(np.asarray(
            a, np.int32 if name in _INT_FIELDS else np.float32),
            device=device)
        for name, a in arrays.items()})


def compile_scene(scene: SceneData, max_leaf: int = 64,
                  device=None) -> TpuScene:
    """Compile a scene and move it onto ``device`` (one transfer per
    scene; default the current CUDA device, and with none visible this
    raises before compiling)."""
    device = resolve_device(device)
    return tpu_scene_from_numpy(**compile_scene_np(scene, max_leaf),
                                device=device)


def create_scene(context, vertices, indices, **kwargs) -> TpuScene:
    """Compile bare geometry on the context's device.

    ``vertices``: (V, 3/4) float32; ``indices``: flat (3T,) or (T, 3).
    Shading attributes default to face/vertex normals derived from the
    geometry; use :func:`compile_scene` with a full SceneData for control.
    """
    from rayaccel_tpu_torch.scene.loader import DEFAULT_MATERIALS

    verts = np.asarray(vertices, np.float32)[:, :3]
    idx = np.asarray(indices, np.uint32).reshape(-1, 3)
    scene = SceneData(
        vertices=verts, indices=idx,
        triangle_materials=np.zeros(len(idx), np.uint16),
        triangle_normals=compute_face_normals(verts, idx),
        normals=compute_vertex_normals(verts, idx),
        texcoords=np.zeros((len(verts), 2), np.float32),
        materials=DEFAULT_MATERIALS.copy(),
    )
    return compile_scene(scene, device=context.device, **kwargs)
