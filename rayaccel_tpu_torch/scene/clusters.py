"""Cluster scene compiler for the dense and sparse engines.

Counterpart of ``rayaccel_tpu/scene/clusters.py`` (``:45-281``). The SAH
BVH is cut into clusters of at most ``cluster_size`` triangles; each
triangle becomes four bilinear Moller-Trumbore feature columns (det, u, v,
t numerators as linear forms over the ray features
f = [d, o, d x o, 1]) plus one attribute row (bf16-pair shading words,
triangle id, exact [v0, e1, e2]). The compile is NumPy and produces the
same arrays as the JAX package, bit for bit; :func:`cluster_scene_from_numpy`
moves them onto a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.scene.bvh import KIND_LEAF, Bvh2, build_bvh
from rayaccel_tpu_torch.scene.data import SceneData

RAY_FEATURES = 16   # 10 used: d(3), o(3), d x o(3), 1; rows 10-15 of G are 0
ATTR_COLS = 18
ATTR_PACK_COLS = 5    # bf16 pairs (hi|lo): [n0x|n0y, n0z|n1x, n1y|n1z,
                      #  n2x|n2y, n2z|mat]
ATTR_TRI_ID_COL = 5   # original triangle id as raw int32 bits
ATTR_GEOM_COL = 6     # [v0, e1, e2] exact geometry in cols 6:15
ATTR_UV_COL = 15      # uv bf16 pairs [uv0u|uv0v, uv1u|uv1v, uv2u|uv2v]
SELECT_PAD = 3e37     # padding cluster box: a far point every slab test culls
# Boxes in a chunk of the select kernel's multi-chunk path, which scenes
# of more boxes than one CTA's shared memory holds take: the kernel's
# kChunk (csrc/select_nearest.cu), whose launch checks the number of union
# boxes (ClusterScene.bb_chunks) computed with this.
SELECT_CHUNK = 2048


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits (uint32) with round-to-nearest-even."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint32)


def _pack_pairs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Two f32 columns -> one f32 word holding (bf16(hi) << 16) | bf16(lo)."""
    return ((_bf16_bits(hi) << 16) | _bf16_bits(lo)).view(np.float32)


class ClusterScene(NamedTuple):
    """Device tensors of a compiled cluster scene: ``N_c`` clusters of ``C``
    padded triangles. The first six fields are the JAX package's
    ``ClusterScene``; ``G3``, ``bb`` and ``G3b`` are layouts of them that
    the kernels read, derived once here instead of once per trace;
    ``bb_chunks`` is the select kernel's union box of each chunk of ``bb``
    (:func:`select_chunk_boxes`)."""

    G: torch.Tensor           # (RAY_FEATURES, N_c*C*4) f32 intersection features
    attrs: torch.Tensor       # (N_c*C, ATTR_COLS) f32 attribute rows
    tri_id: torch.Tensor      # (N_c*C,) int32 original triangle id (-1 pad)
    cl_bbmin: torch.Tensor    # (N_c, 3) f32
    cl_bbmax: torch.Tensor    # (N_c, 3) f32
    mat_params: torch.Tensor  # (M, 4) f32
    G3: torch.Tensor          # (N_c, 4C, 16) f32: cluster-major G
    bb: torch.Tensor          # (n_cp, 6) f32: [bbmin | bbmax], padded to a
                              # multiple of 128 clusters with SELECT_PAD
    G3b: torch.Tensor         # (N_c, ceil(C/4), 32, 4) int32: G3 in bf16,
                              # in mma fragment order (mma_fragments)
    bb_chunks: torch.Tensor   # (ceil(n_cp / SELECT_CHUNK), 6) f32

    @property
    def cluster_size(self) -> int:
        return self.attrs.shape[0] // self.cl_bbmin.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.cl_bbmin.shape[0]


def unpack_attrs_np(attrs: np.ndarray) -> dict:
    """Decode the bf16-pair shading words of attribute rows (NumPy, for
    tests and debugging; the frame unpacks them in
    ``render/shading.py``). Counterpart of
    ``rayaccel_tpu/scene/clusters.py:unpack_attrs_np``."""
    w = np.ascontiguousarray(attrs[:, :ATTR_PACK_COLS],
                             np.float32).view(np.uint32)
    hi = (w & np.uint32(0xFFFF0000)).view(np.float32)
    lo = (w << np.uint32(16)).view(np.float32)
    wu = np.ascontiguousarray(attrs[:, ATTR_UV_COL:ATTR_UV_COL + 3],
                              np.float32).view(np.uint32)
    uhi = (wu & np.uint32(0xFFFF0000)).view(np.float32)
    ulo = (wu << np.uint32(16)).view(np.float32)
    return {
        "n0": np.stack([hi[:, 0], lo[:, 0], hi[:, 1]], -1),
        "n1": np.stack([lo[:, 1], hi[:, 2], lo[:, 2]], -1),
        "n2": np.stack([hi[:, 3], lo[:, 3], hi[:, 4]], -1),
        "mat": lo[:, 4],
        "uv0": np.stack([uhi[:, 0], ulo[:, 0]], -1),
        "uv1": np.stack([uhi[:, 1], ulo[:, 1]], -1),
        "uv2": np.stack([uhi[:, 2], ulo[:, 2]], -1),
    }


def _cluster_cut(bvh: Bvh2, max_tris: int):
    """Cut the BVH into maximal subtrees with <= max_tris triangles.
    Returns list of (start, end) prim_order ranges + their bounds."""
    out = []
    stack = [0]
    while stack:
        i = stack.pop()
        if bvh.kind[i] == KIND_LEAF:
            out.append((int(bvh.first[i]), int(bvh.last[i]),
                        bvh.bbmin[i], bvh.bbmax[i]))
            continue
        lo, hi = _subtree_range(bvh, i)
        if hi - lo <= max_tris:
            out.append((lo, hi, bvh.bbmin[i], bvh.bbmax[i]))
        else:
            stack.append(int(bvh.first[i]))
            stack.append(int(bvh.last[i]))
    out.sort(key=lambda r: r[0])
    return out


def _merge_cut(cut, max_tris: int, sa_gain: float = 0.8):
    """Greedily merge adjacent cut ranges when the union still fits a
    cluster and its bounding box is tight (union surface area <= sa_gain *
    the sum of the parts')."""
    def sa(bmin, bmax):
        e = np.maximum(np.asarray(bmax) - np.asarray(bmin), 0.0)
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    out = [list(cut[0])]
    for lo, hi, bmin, bmax in cut[1:]:
        plo, phi, pbmin, pbmax = out[-1]
        if hi - plo <= max_tris:
            ubmin = np.minimum(pbmin, bmin)
            ubmax = np.maximum(pbmax, bmax)
            if sa(ubmin, ubmax) <= sa_gain * (sa(pbmin, pbmax)
                                              + sa(bmin, bmax)):
                out[-1] = [plo, hi, ubmin, ubmax]
                continue
        out.append([lo, hi, bmin, bmax])
    return [tuple(x) for x in out]


def _subtree_range(bvh: Bvh2, i: int):
    j = i
    while bvh.kind[j] != KIND_LEAF:
        j = int(bvh.first[j])
    lo = int(bvh.first[j])
    j = i
    while bvh.kind[j] != KIND_LEAF:
        j = int(bvh.last[j])
    hi = int(bvh.last[j])
    return lo, hi


def _tri_feature_columns(v0, e1, e2):
    """Feature columns (16, 4) per triangle for the bilinear MT form."""
    n = np.cross(e1, e2)
    cols = np.zeros((len(v0), RAY_FEATURES, 4), np.float64)
    cols[:, 0:3, 0] = np.cross(e2, e1)          # det = d . (e2 x e1)
    cols[:, 6:9, 1] = -e2                       # u_num
    cols[:, 0:3, 1] = -np.cross(e2, v0)
    cols[:, 6:9, 2] = e1                        # v_num
    cols[:, 0:3, 2] = -np.cross(v0, e1)
    cols[:, 3:6, 3] = n                         # t_num = o . n - v0 . n
    cols[:, 9, 3] = -np.sum(v0 * n, axis=-1)
    return cols.astype(np.float32)


def compile_clusters_np(scene: SceneData, cluster_size: int = 128,
                        bvh: Bvh2 | None = None) -> dict:
    """The NumPy cluster compile: a dict of the six ``ClusterScene`` base
    arrays (G, attrs, tri_id, cl_bbmin, cl_bbmax, mat_params)."""
    verts = np.asarray(scene.vertices, np.float64)
    idx = np.asarray(scene.indices, np.int64)
    if bvh is None:
        bvh = build_bvh(scene.vertices, idx, max_leaf=min(cluster_size, 127))

    cut = _merge_cut(_cluster_cut(bvh, cluster_size), cluster_size)
    n_c = len(cut)
    C = cluster_size
    TP = n_c * C

    tri_id = np.full(TP, -1, np.int64)
    cl_bbmin = np.zeros((n_c, 3), np.float32)
    cl_bbmax = np.zeros((n_c, 3), np.float32)
    for c, (lo, hi, bmin, bmax) in enumerate(cut):
        ids = bvh.prim_order[lo:hi]
        tri_id[c * C:c * C + len(ids)] = ids
        cl_bbmin[c] = bmin
        cl_bbmax[c] = bmax

    # Geometry features (zero columns for padding => det = 0 => never hit),
    # column layout per cluster [det(C) | u_num(C) | v_num(C) | t_num(C)].
    G = np.zeros((TP, RAY_FEATURES, 4), np.float32)
    real = tri_id >= 0
    rid = tri_id[real]
    v0 = verts[idx[rid, 0]]
    v1 = verts[idx[rid, 1]]
    v2 = verts[idx[rid, 2]]
    G[real] = _tri_feature_columns(v0, v1 - v0, v2 - v0)
    G = (G.reshape(n_c, C, RAY_FEATURES, 4)
          .transpose(2, 0, 3, 1)            # (16, n_c, 4, C)
          .reshape(RAY_FEATURES, TP * 4)
          .copy())

    A = np.zeros((TP, ATTR_COLS), np.float32)
    vn = np.asarray(scene.normals, np.float32)
    vt = np.asarray(scene.texcoords, np.float32)
    n0, n1, n2 = vn[idx[rid, 0]], vn[idx[rid, 1]], vn[idx[rid, 2]]
    uv0, uv1, uv2 = vt[idx[rid, 0]], vt[idx[rid, 1]], vt[idx[rid, 2]]
    mat = np.asarray(scene.triangle_materials, np.float32)[rid]
    # The material id rides a bf16 half-word: integers are exact only up
    # to 256.
    if mat.size and mat.max() > 256:
        raise ValueError(
            f"material id {int(mat.max())} exceeds the bf16-exact packing "
            "range (256); widen ATTR packing before using more materials")
    A[real, 0] = _pack_pairs(n0[:, 0], n0[:, 1])
    A[real, 1] = _pack_pairs(n0[:, 2], n1[:, 0])
    A[real, 2] = _pack_pairs(n1[:, 1], n1[:, 2])
    A[real, 3] = _pack_pairs(n2[:, 0], n2[:, 1])
    A[real, 4] = _pack_pairs(n2[:, 2], mat)
    A[real, ATTR_UV_COL + 0] = _pack_pairs(uv0[:, 0], uv0[:, 1])
    A[real, ATTR_UV_COL + 1] = _pack_pairs(uv1[:, 0], uv1[:, 1])
    A[real, ATTR_UV_COL + 2] = _pack_pairs(uv2[:, 0], uv2[:, 1])
    A[:, ATTR_TRI_ID_COL] = tri_id.astype(np.int32).view(np.float32)
    A[real, ATTR_GEOM_COL + 0:ATTR_GEOM_COL + 3] = v0
    A[real, ATTR_GEOM_COL + 3:ATTR_GEOM_COL + 6] = v1 - v0
    A[real, ATTR_GEOM_COL + 6:ATTR_GEOM_COL + 9] = v2 - v0

    return dict(G=G, attrs=A, tri_id=tri_id.astype(np.int32),
                cl_bbmin=cl_bbmin, cl_bbmax=cl_bbmax,
                mat_params=np.asarray(scene.materials, np.float32))


def mma_fragment_index(C: int) -> torch.Tensor:
    """The layout of :func:`mma_fragments` for clusters of C: a (ceil(C/4),
    32, 8) int64 map from (group q, lane, bf16 half) to the element of a
    cluster's (4C, 16) G3 block it holds (row * 16 + feature), -1 where it
    holds zero (a feature past 9 or a triangle past C).

    Group q holds triangles 4q .. 4q + 3 as the two B operands (16 features
    x 8 columns) of ``mma.sync.m16n8k16`` in ``csrc/common.cuh:mma_rays``:
    column n of product p is kind 2p + (n & 1) (det, u; v, t numerator) of
    triangle 4q + (n >> 1). By the PTX fragment layout, lane 4g + t holds
    column g of B: in its register r (of two) features 2t + 8r and
    2t + 8r + 1, the lower one in the low half. A lane's 16 bytes are its
    registers of product 0, then of product 1."""
    q = torch.arange(-(-C // 4))[:, None, None]
    lane = torch.arange(32)[None, :, None]
    half = torch.arange(8)[None, None, :]
    g, t = lane // 4, lane % 4
    product, reg, low = half // 4, half // 2 % 2, half % 2
    feature = 2 * t + 8 * reg + low
    tri = 4 * q + g // 2
    row = (2 * product + g % 2) * C + tri
    return torch.where((feature < 10) & (tri < C), row * RAY_FEATURES + feature,
                       -1)


def mma_fragments(G3: torch.Tensor) -> torch.Tensor:
    """G3 (N_c, 4C, 16) rounded to bf16 (nearest even, as ``.to(torch.
    bfloat16)``) and laid out as the B fragments of the dense kernels'
    bf16 variants (:func:`mma_fragment_index`): (N_c, ceil(C/4), 32, 4)
    int32 words of two bf16 each, so each lane loads its two fragments of
    a group of 4 triangles with one 16-byte load. 16 KB a cluster at
    C = 128 (G3: 32 KB)."""
    n_c, C4, _ = G3.shape
    idx = mma_fragment_index(C4 // 4).to(G3.device).reshape(-1)
    flat = torch.cat([G3.reshape(n_c, -1).to(torch.bfloat16),
                      torch.zeros((n_c, 1), dtype=torch.bfloat16,
                                  device=G3.device)], dim=1)
    out = flat[:, torch.where(idx >= 0, idx, flat.shape[1] - 1)]
    return out.view(torch.int32).reshape(n_c, -1, 32, 4)


def select_chunk_boxes(bb: torch.Tensor,
                       chunk: int = SELECT_CHUNK) -> torch.Tensor:
    """(ceil(n_cp / chunk), 6) float32: the union box [min | max] of each
    run of ``chunk`` boxes of ``bb`` (n_cp, 6), each box's planes first put
    in order on each axis as the select kernel stages them (a pair with a
    NaN stays as it is, and a NaN plane makes the union's NaN). Every box
    of a chunk lies inside its union, which lets the kernel skip chunks."""
    lo, hi = bb[:, :3], bb[:, 3:]
    swap = lo > hi
    lo, hi = torch.where(swap, hi, lo), torch.where(swap, lo, hi)
    n = -(-bb.shape[0] // chunk)
    # Repeating the last box to whole chunks changes no union.
    pad = n * chunk - bb.shape[0]
    lo = torch.cat([lo, lo[-1:].expand(pad, 3)]).reshape(n, chunk, 3)
    hi = torch.cat([hi, hi[-1:].expand(pad, 3)]).reshape(n, chunk, 3)
    return torch.cat([lo.amin(dim=1), hi.amax(dim=1)], dim=1).contiguous()


def cluster_scene_from_numpy(G, attrs, tri_id, cl_bbmin, cl_bbmax,
                             mat_params, device=None) -> ClusterScene:
    """Move compiled cluster arrays onto ``device`` (``device.py:
    resolve_device``: default the current CUDA device) and derive the
    kernel layouts. Takes the JAX package's ``ClusterScene`` fields as well
    (``np.asarray`` of each), so both packages can trace one scene."""
    device = resolve_device(device)
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    G = f32(G)
    cl_bbmin = f32(cl_bbmin)
    cl_bbmax = f32(cl_bbmax)
    n_c = cl_bbmin.shape[0]
    C4 = G.shape[1] // n_c
    G3 = G.reshape(RAY_FEATURES, n_c, C4).permute(1, 2, 0).contiguous()
    n_cp = -(-n_c // 128) * 128
    bb = torch.full((n_cp, 6), SELECT_PAD, dtype=torch.float32, device=device)
    bb[:n_c, 0:3] = cl_bbmin
    bb[:n_c, 3:6] = cl_bbmax
    return ClusterScene(
        G=G, attrs=f32(attrs),
        tri_id=torch.tensor(np.asarray(tri_id, np.int32), device=device),
        cl_bbmin=cl_bbmin, cl_bbmax=cl_bbmax, mat_params=f32(mat_params),
        G3=G3, bb=bb, G3b=mma_fragments(G3),
        bb_chunks=select_chunk_boxes(bb))


def compile_clusters(scene: SceneData, cluster_size: int = 128,
                     bvh: Bvh2 | None = None, device=None) -> ClusterScene:
    """Compile a SceneData into the cluster-dense device form on
    ``device`` (default the current CUDA device, and with none visible this
    raises before compiling)."""
    device = resolve_device(device)
    return cluster_scene_from_numpy(
        **compile_clusters_np(scene, cluster_size, bvh), device=device)
