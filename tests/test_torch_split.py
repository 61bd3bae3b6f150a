"""What the sparse engine's kernels rely on, held on the CPU.

K2 (``csrc/select_nearest.cu``) splits a lane's boxes across up to 32
threads and merges their sorted lists, and answers a dead lane of a live
tile in closed form without testing a box. K3 (``csrc/pair_hit.cu``) splits
a cluster's columns across 8 threads and merges their packed minima. The
plain versions take the same splits as arguments; every split must give
the unsplit answer bitwise, and the closed form must equal what the plain
version computes for such lanes. The inputs are a small battlefield-like
scene (>128 clusters of 8) and rays from a numpy seed whose origins lie
inside the scene's boxes, so many entries tie at 0; the unsplit plain
versions are the ones tests/test_torch_sparse.py holds against the JAX
package's Pallas kernels."""

import numpy as np
import pytest
import torch

from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_battlefield_like

from rayaccel_tpu_torch.ops import trace_sparse as sparse
from rayaccel_tpu_torch.ops.intersect import safe_inv_dir

from tests.torch_helpers import port_scene

torch.set_num_threads(2)

N = 2048
INT_MIN = -0x80000000


@pytest.fixture(scope="module")
def scene():
    cs = port_scene(compile_clusters(
        make_battlefield_like(n_objects=40, grid=21), cluster_size=8))
    assert cs.n_clusters > 128
    return cs


@pytest.fixture(scope="module")
def rays(scene):
    """(o, d, tmin, tmax_eff): origins inside the scene's bounds, one dead
    select tile, dead lanes scattered in live tiles (tmax_eff = -1) and a
    few lanes whose window is empty with both ends positive."""
    rs = np.random.default_rng(11)
    lo, hi = scene.cl_bbmin.amin(0).numpy(), scene.cl_bbmax.amax(0).numpy()
    o = rs.uniform(lo, hi, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.zeros(N, np.float32)
    tmax = np.full(N, 1e6, np.float32)
    tmax[1024:1536] = -1.0
    tmax[rs.random(N) < 0.3] = -1.0
    tmin[100:110], tmax[100:110] = 5.0, 2.0
    return tuple(torch.tensor(a) for a in (o, d, tmin, tmax))


def _select_inputs(scene, rays, prev=None):
    """K2's arguments as ``_select`` builds them (select tiles of 512)."""
    o, d, tmin, tmax = rays
    n_cp = scene.bb.shape[0]
    live = ((tmax > 0).reshape(-1, 512).any(dim=1).repeat_interleave(512)
            .to(torch.uint8))
    if prev is None:
        prev = torch.full((N,), INT_MIN, dtype=torch.int32)
    F8 = torch.cat([o, safe_inv_dir(d), tmin[:, None], tmax[:, None]], dim=1)
    return F8, prev, live, scene.bb, max((n_cp - 1).bit_length(), 1)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("split", [1, 2, 8, 32])
def test_select_box_split_keeps_the_answer(scene, rays, split, k):
    """The merged lists of a box split equal the unsplit words, spill
    words and counts, bitwise: on a first pass, and on a restart pass that
    excludes the words below each lane's spill word."""
    F8, prev, live, bb, id_bits = _select_inputs(scene, rays)
    first = sparse.select_nearest_plain(F8, prev, live, bb, k, id_bits)
    tied = ((first[:k + 1] & ~((1 << id_bits) - 1)) == 0).sum(dim=0)
    assert (tied > 1).any()                      # entries tied at 0
    assert (first[k + 1] > k).any()              # lanes that spill
    got = sparse.select_nearest_plain(F8, prev, live, bb, k, id_bits,
                                      split=split)
    assert torch.equal(got, first)
    spill = first[k].contiguous()
    want = sparse.select_nearest_plain(F8, spill, live, bb, k, id_bits)
    assert not torch.equal(want, first)
    got = sparse.select_nearest_plain(F8, spill, live, bb, k, id_bits,
                                      split=split)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("prev_kind", ["int_min", "finite", "inf_word"])
def test_dead_lane_closed_form_matches_plain(scene, rays, prev_kind, k):
    """For a lane of a live tile with tmax_eff < tmin, the closed form
    equals the plain version's words, spill word and count, under no
    previous word, a finite one and an 0x7F800000 | c one."""
    n_cp = scene.bb.shape[0]
    rs = np.random.default_rng(k)
    prev = {"int_min": np.full(N, INT_MIN, np.int64),
            "finite": rs.integers(0x3F000000, 0x42000000, N),
            "inf_word": 0x7F800000 | rs.integers(0, n_cp, N)}[prev_kind]
    if prev_kind == "inf_word":
        prev[::7] = 0x7F800000 | (n_cp - 1)      # only the last box is left
        prev[::11] = 0x7F800000 | n_cp           # nothing is left
    prev = torch.tensor(prev.astype(np.int32))
    F8, _, live, bb, id_bits = _select_inputs(scene, rays)
    want = sparse.select_nearest_plain(F8, prev, live, bb, k, id_bits)
    dead = (live == 1) & (F8[:, 7] < F8[:, 6])
    assert dead.sum() > 100 and (F8[dead, 7] > 0).any()
    got = sparse.dead_lane_words(prev[dead], n_cp, k)
    assert torch.equal(got, want[:, dead])
    assert (got[k + 1] == 0).all()


@pytest.mark.parametrize("guard_tmax", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("col_split", [1, 4, 8])
def test_pair_column_split_keeps_the_answer(scene, rays, col_split,
                                            guard_tmax):
    """The merged packed minima of a column split equal the unsplit pair
    words, bitwise, on the pairs of a first pass (items cut at SP = 512)."""
    o, d, tmin, tmax = rays
    k = 4
    lat_valid, lat_id, _ = sparse._select(scene, o, safe_inv_dir(d), tmin,
                                          tmax, k)
    cl, ray, rank, total = sparse._lattice_pairs(lat_valid, lat_id, k * N)
    assert total == cl.numel() > 512           # more than one SP block
    tmax_p = torch.where(tmax > 0, torch.full_like(tmax, 3.0), tmax)
    Fp, items = sparse._pair_inputs(o, d, tmin, tmax_p, cl, ray, rank, 512)
    col_bits = max((scene.cluster_size - 1).bit_length(), 1)
    want = sparse.pair_hit_plain(Fp, scene.G3, items, col_bits, guard_tmax)
    assert (want < sparse._MISS_BITS).any()
    got = sparse.pair_hit_plain(Fp, scene.G3, items, col_bits, guard_tmax,
                                col_split=col_split)
    assert torch.equal(got, want)
    if guard_tmax:
        open_ = sparse.pair_hit_plain(Fp, scene.G3, items, col_bits, False)
        assert (open_ < sparse._MISS_BITS).sum() > (want
                                                    < sparse._MISS_BITS).sum()
