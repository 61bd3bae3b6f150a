"""The port's dense work-queue engine (cull + queue, K1's plain version,
winner reconstruction) against the JAX package's ``trace_mxu_pallas``
(Pallas interpret mode) and the brute-force oracle."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rayaccel_tpu.ops.bruteforce import trace_bruteforce
from rayaccel_tpu.ops.intersect import safe_inv_dir as jax_inv
from rayaccel_tpu.ops.trace_pallas import _cull_and_queue, trace_mxu_pallas
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.compile import compile_scene
from rayaccel_tpu.scene.loader import make_test_scene

from rayaccel_tpu_torch.ops import trace_dense as dense
from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
from rayaccel_tpu_torch.ops.trace_dense import cull_and_queue, trace_dense

from tests.test_trace import assert_hits_match_near_ties
from tests.torch_helpers import (assert_agrees_with_jax, camera_rays,
                                 port_rays, port_scene, random_rays)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    sd = make_test_scene()
    jcs = compile_clusters(sd, cluster_size=16)
    return sd, compile_scene(sd), jcs, port_scene(jcs)


@pytest.fixture(scope="module", params=["camera", "random"])
def rays(request, scenes):
    sd = scenes[0]
    return camera_rays(sd) if request.param == "camera" else random_rays(1234)


def test_dense_matches_bruteforce(scenes, rays):
    _, ts, _, cs = scenes
    res, overflow = trace_dense(cs, port_rays(rays), tile=512)
    assert int(overflow) == 0
    assert (res.hits.tri >= 0).float().mean() > 0.3
    assert_hits_match_near_ties(trace_bruteforce(ts.tri_verts, rays),
                                res.hits, rays)


def test_dense_matches_pallas(scenes, rays):
    _, _, jcs, cs = scenes
    ref, ov_ref = trace_mxu_pallas(jcs, rays, tile=512)
    res, overflow = trace_dense(cs, port_rays(rays), tile=512)
    assert int(overflow) == int(ov_ref) == 0
    assert_agrees_with_jax(res.hits, ref.hits)
    # The attribute row is the winner's.
    hit = res.hits.tri >= 0
    same = hit.numpy() & (res.hits.tri.numpy() == np.asarray(ref.hits.tri))
    np.testing.assert_array_equal(res.attrs.numpy()[same],
                                  np.asarray(ref.attrs)[same])


def test_queue_matches_pallas_queue(scenes):
    """Per tile, the same clusters in the same front-to-back entry order,
    the same K-padded counts, and the same clamp overflow."""
    sd, _, jcs, cs = scenes
    jr = camera_rays(sd)
    T, tile = 8, 512
    for K, cap in ((4, 4), (4, 256), (1, 2)):
        inv = jax_inv(jr.d)
        items, entries, n_items, ov_ref = _cull_and_queue(
            jcs, tuple(jr.o[:, a] for a in range(3)),
            tuple(inv[:, a] for a in range(3)), jr.tmin, jr.tmax, T, tile,
            k_step=K, tile_cap=cap)
        r = port_rays(jr)
        q_cl, q_en, q_n, ov = cull_and_queue(
            cs, r.o, safe_inv_dir(r.d), r.tmin, r.tmax, T, tile, K, cap)
        assert int(ov) == int(ov_ref)
        items = np.asarray(items)[:int(n_items)]
        entries = np.asarray(entries)[:int(n_items)]
        assert int(q_n.sum()) == len(items)
        off = 0
        for t in range(T):
            n = int(q_n[t])
            assert np.all(items[off:off + n] >> 16 == t)
            np.testing.assert_array_equal(q_en[t, :n].numpy(),
                                          entries[off:off + n])
            # Ties in entry distance may order differently; the multiset
            # of clusters per entry value may not.
            got = sorted(zip(q_en[t, :n].tolist(), q_cl[t, :n].tolist()))
            want = sorted(zip(entries[off:off + n].tolist(),
                              (items[off:off + n] & 0xFFFF).tolist()))
            assert got == want
            off += n


def test_tile_cap_overflow_counted_like_pallas(scenes):
    """A clamp that drops clusters is counted, as in the JAX engine."""
    sd, _, jcs, cs = scenes
    jr = camera_rays(sd)
    # The test scene has 4 clusters: K = 1 lets a cap of 2 bind.
    ref, ov_ref = trace_mxu_pallas(jcs, jr, tile=512, k_step=1, tile_cap=2)
    res, ov = trace_dense(cs, port_rays(jr), tile=512, k_step=1, tile_cap=2)
    assert int(ov) == int(ov_ref) > 0
    np.testing.assert_array_equal(res.hits.tri.numpy() >= 0,
                                  np.asarray(ref.hits.tri) >= 0)


def test_tile_cap_must_be_multiple_of_k_step(scenes):
    sd, _, _, cs = scenes
    r = port_rays(camera_rays(sd))
    with pytest.raises(ValueError, match="multiple"):
        trace_dense(cs, r, tile=512, k_step=4, tile_cap=6)


def test_inactive_lanes_miss(scenes):
    _, _, jcs, cs = scenes
    r = port_rays(random_rays(7))
    active = torch.arange(r.o.shape[0]) % 3 != 0
    res, _ = trace_dense(cs, r, active=active, tile=512)
    full, _ = trace_dense(cs, r, tile=512)
    assert (res.hits.tri[~active] == -1).all()
    np.testing.assert_array_equal(res.hits.tri[active].numpy(),
                                  full.hits.tri[active].numpy())


@pytest.mark.parametrize("k_step,tile_cap", [(4, 4), (4, 256), (1, 2)])
def test_queue_on_cpu_tensors_runs_the_plain_version(scenes, k_step,
                                                     tile_cap):
    sd, _, _, cs = scenes
    r = port_rays(camera_rays(sd))
    a = (cs, r.o, safe_inv_dir(r.d), r.tmin, r.tmax, r.o.shape[0] // 512,
         512, k_step, tile_cap)
    launches = dense.cull_and_queue.launches
    got = cull_and_queue(*a)
    want = dense.cull_and_queue_plain(*a)
    assert dense.cull_and_queue.launches == launches
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _meta_queue_args(R=1024, n_c=8):
    """Arguments of a cull of R rays in tiles of 512 on the meta device,
    which goes to the kernel's checks and can never launch."""
    cs = SimpleNamespace(cl_bbmin=torch.empty((n_c, 3), device="meta"),
                         cl_bbmax=torch.empty((n_c, 3), device="meta"))
    return dict(cs=cs, o=torch.empty((R, 3), device="meta"),
                inv_d=torch.empty((R, 3), device="meta"),
                tmin=torch.empty(R, device="meta"),
                tmax_eff=torch.empty(R, device="meta"), T=R // 512, tile=512)


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA"),
    (dict(k_step=4, tile_cap=6), "multiple"),
    (dict(tile_cap=dense.QUEUE_MAX_CAP + 4), "up to"),
    (dict(tile=0), "tile"),
    (dict(cs=SimpleNamespace(cl_bbmin=torch.empty((0, 3), device="meta"),
                             cl_bbmax=torch.empty((0, 3), device="meta"))),
     "no clusters"),
], ids=["not_cuda", "cap_not_multiple", "cap_above_limit", "tile",
        "no_clusters"])
def test_queue_kernel_checks_raise_before_any_launch(change, match):
    """Tensors off the CPU go to the kernel's checks, never to the plain
    version, and each check raises before the kernel library is built."""
    launches = dense.cull_and_queue.launches
    with pytest.raises(ValueError, match=match):
        cull_and_queue(**{**_meta_queue_args(), **change})
    assert dense.cull_and_queue.launches == launches
