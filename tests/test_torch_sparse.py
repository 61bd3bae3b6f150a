"""The port's sparse pair engine (K2's and K3's plain versions, the pair
pipeline, the restart loop) against the JAX package's ``trace_sparse`` and
``_select_nearest_pallas`` (Pallas interpret mode) and the brute-force
oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayaccel_tpu.ops.bruteforce import trace_bruteforce
from rayaccel_tpu.ops.intersect import safe_inv_dir as jax_inv
from rayaccel_tpu.ops.trace_sparse import _select_nearest_pallas
from rayaccel_tpu.ops.trace_sparse import trace_sparse as jax_trace_sparse
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.compile import compile_scene
from rayaccel_tpu.scene.data import (SceneData, compute_face_normals,
                                     compute_vertex_normals)
from rayaccel_tpu.scene.loader import make_battlefield_like, make_test_scene
from rayaccel_tpu.types import make_rays

from rayaccel_tpu_torch.ops import trace_sparse as sparse
from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
from rayaccel_tpu_torch.ops.trace_sparse import trace_sparse

from tests.test_trace import assert_hits_match_near_ties
from tests.torch_helpers import (assert_agrees_with_jax, camera_rays,
                                 port_rays, port_scene, random_rays)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    sd = make_test_scene()
    jcs = compile_clusters(sd, cluster_size=16)
    return sd, compile_scene(sd), jcs, port_scene(jcs)


@pytest.fixture(scope="module")
def battlefield():
    """A small battlefield-like scene: 120 clusters of 16."""
    jcs = compile_clusters(make_battlefield_like(n_objects=40, grid=21),
                           cluster_size=16)
    return jcs, port_scene(jcs)


@pytest.fixture(scope="module", params=["camera", "random"])
def rays(request, scenes):
    return (camera_rays(scenes[0]) if request.param == "camera"
            else random_rays(1234))


@pytest.mark.parametrize("k", [4, 6, 8])
def test_select_plain_matches_pallas_bitwise(k):
    """K2's plain version against the Pallas select kernel: the same
    nearest-k words, spill words and counts, bit for bit, including the
    previous-spill exclusion and the dead-tile masking."""
    sd = make_battlefield_like(n_objects=40, grid=21)
    jcs = compile_clusters(sd, cluster_size=8)          # > 128 clusters
    cs = port_scene(jcs)
    assert cs.n_clusters > 128
    rs = np.random.default_rng(k)
    n = 4096
    lo, hi = cs.cl_bbmin.amin(0).numpy(), cs.cl_bbmax.amax(0).numpy()
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e6, np.float32)
    tmax[1024:2048] = -1.0             # one dead select tile
    tmax[3000:3100] = -1.0             # dead lanes in a live tile
    inv = np.asarray(jax_inv(jnp.asarray(d)))

    def both(prev):
        ref = _select_nearest_pallas(
            jcs, tuple(jnp.asarray(o[:, a]) for a in range(3)),
            tuple(jnp.asarray(inv[:, a]) for a in range(3)),
            jnp.asarray(tmin), jnp.asarray(tmax), k, interpret=True,
            prev_packed=None if prev is None else jnp.asarray(prev))
        rays = (cs, torch.tensor(o), safe_inv_dir(torch.tensor(d)),
                torch.tensor(tmin), torch.tensor(tmax))
        pv = None if prev is None else torch.tensor(prev)
        got = sparse._select(*rays, k, pv)
        # The program's select asks for no count: read it from K2's row.
        F8, pv, live, id_bits = sparse._select_args(*rays, pv)
        cnt = sparse.select_nearest(F8, pv, live, cs.bb, k, id_bits)[k + 1]
        lv = np.asarray(ref[0])
        np.testing.assert_array_equal(got[0].numpy(), lv)
        np.testing.assert_array_equal(got[1].numpy()[lv], np.asarray(ref[1])[lv])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[3]))
        return got, cnt

    first, cnt = both(None)
    assert (cnt > k).any() and first[0].any()
    both(first[2].numpy())             # restart: exclude consumed words


def test_sparse_matches_bruteforce(scenes, rays):
    _, ts, _, cs = scenes
    res, overflow = trace_sparse(cs, port_rays(rays), sp_tile=512)
    assert int(overflow) == 0
    assert_hits_match_near_ties(trace_bruteforce(ts.tri_verts, rays),
                                res.hits, rays)


def test_sparse_matches_jax(scenes, rays):
    _, _, jcs, cs = scenes
    ref, ov_ref = jax_trace_sparse(jcs, rays, sp_tile=512)
    res, overflow = trace_sparse(cs, port_rays(rays), sp_tile=512)
    assert int(overflow) == int(ov_ref) == 0
    assert_agrees_with_jax(res.hits, ref.hits)


@pytest.mark.parametrize("kw", [dict(k_pairs=2, max_passes=8),
                                dict(k_pairs=1, max_passes=8, k_restart=8),
                                dict(k_pairs=4, k_first=1, max_passes=8)])
def test_sparse_multipass_exact(scenes, kw):
    """Restarts past the spill word stay exact with small k."""
    _, ts, jcs, cs = scenes
    jr = random_rays(99, n=2048)
    res, overflow = trace_sparse(cs, port_rays(jr), sp_tile=512, **kw)
    assert int(overflow) == 0
    assert_hits_match_near_ties(trace_bruteforce(ts.tri_verts, jr),
                                res.hits, jr)


@pytest.mark.parametrize("kw", [dict(k_pairs=4, pair_budget=1),
                                dict(k_pairs=2, pair_budget=1, max_passes=2),
                                dict(k_pairs=1, max_passes=1)])
def test_overflow_counts_match_jax(battlefield, kw):
    """Truncated pairs and rays unresolved at the pass cap are counted as
    the JAX engine counts them. Pair truncation depends only on the
    bitwise-equal select output and the shared caps, so its count is
    exact. Whether a ray is unresolved compares its spill entry with the
    packed best score, which JAX's interpret mode ranks through a bf16
    reciprocal (~2^-8 relative): rays whose spill entry lies that close to
    their hit may count differently, so the pass-cap case allows 0.5% of
    the rays."""
    jcs, cs = battlefield
    lo = np.asarray(jcs.cl_bbmin).min(0)
    hi = np.asarray(jcs.cl_bbmax).max(0)
    rs = np.random.default_rng(5)
    o = rs.uniform(lo, hi, (2048, 3)).astype(np.float32)
    d = rs.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jr = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=1e6)
    ref, ov_ref = jax_trace_sparse(jcs, jr, sp_tile=512, **kw)
    res, ov = trace_sparse(cs, port_rays(jr), sp_tile=512, **kw)
    assert int(ov_ref) > 0
    if kw.get("max_passes", 4) > 1:
        assert int(ov) == int(ov_ref)
        np.testing.assert_array_equal(res.hits.tri.numpy() >= 0,
                                      np.asarray(ref.hits.tri) >= 0)
    else:
        assert abs(int(ov) - int(ov_ref)) <= 0.005 * 2048


def test_tied_entries_make_progress(rng):
    """Rays starting inside several cluster boxes (all entries tied at 0)
    resolve exactly through the previous-spill exclusion (the scene of
    tests/test_trace_sparse.py::test_sparse_restart_progress_on_tied_entries)."""
    n_tri = 64
    verts, idx = [], []
    for i in range(n_tri):
        a = 2 * np.pi * i / n_tri
        b = a + 0.05
        bi = len(verts)
        verts += [(0.0, 1.0, 0.0), (3 * np.cos(a), 1.3, 3 * np.sin(a)),
                  (3 * np.cos(b), 0.7, 3 * np.sin(b))]
        idx.append((bi, bi + 1, bi + 2))
    verts = np.asarray(verts, np.float32)
    idx = np.asarray(idx, np.uint32)
    sd = SceneData(
        vertices=verts, indices=idx,
        triangle_materials=np.zeros(len(idx), np.uint16),
        triangle_normals=compute_face_normals(verts, idx),
        normals=compute_vertex_normals(verts, idx),
        texcoords=np.zeros((len(verts), 2), np.float32),
        materials=np.asarray([[0.8, 0.8, 0.8, 1.5]], np.float32)).validate()
    cs = port_scene(compile_clusters(sd, cluster_size=8))
    n = 512
    o = np.tile(np.asarray([1e-3, 1.0, 2e-3], np.float32), (n, 1))
    d = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jr = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=1e6)
    res, overflow = trace_sparse(cs, port_rays(jr), sp_tile=512, k_pairs=1,
                                 max_passes=24)
    assert int(overflow) == 0
    assert_hits_match_near_ties(
        trace_bruteforce(compile_scene(sd).tri_verts, jr), res.hits, jr)


def test_pair_plain_writes_only_covered_lanes(scenes):
    """K3's plain version writes a pair only if an item covers it and the
    pair's lane word names the item's cluster; the rest keep the miss
    marker."""
    _, _, _, cs = scenes
    r = port_rays(random_rays(3, n=64))
    cl = torch.tensor([0] * 20 + [1] * 20 + [2] * 24)
    ray = torch.arange(64)
    rank = torch.zeros(64, dtype=torch.int64)
    Fp, items = sparse._pair_inputs(r.o, r.d, r.tmin, r.tmax, cl, ray, rank,
                                    32)
    assert items.tolist() == [[0, 20, 0], [20, 32, 1], [32, 40, 1],
                              [40, 64, 2]]
    full = sparse.pair_hit_plain(Fp, cs.G3, items, 4, False)
    assert (full < sparse._MISS_BITS).any()
    part = sparse.pair_hit_plain(Fp, cs.G3, items[[0, 3]], 4, False)
    covered = (cl != 1).numpy()
    np.testing.assert_array_equal(part.numpy()[covered], full.numpy()[covered])
    assert (part[~torch.tensor(covered)] == sparse._MISS_BITS).all()
    wrong = items.clone()
    wrong[0, 2] = 3                          # names a cluster no lane has
    assert (sparse.pair_hit_plain(Fp, cs.G3, wrong, 4, False)[:20]
            == sparse._MISS_BITS).all()
