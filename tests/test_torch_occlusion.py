"""The port's any-hit engines and the environment fold of its trace
wrappers against the JAX package: ``trace_occlusion_dense`` (K4's plain
version) against ``trace_occlusion_pallas`` (Pallas interpret mode),
``trace_occlusion_sparse`` against its JAX counterpart, and ``miss_rgb`` of
``trace_dense(env=)`` / ``trace_sparse(env=)``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayaccel_tpu.environment import create_environment as jax_env
from rayaccel_tpu.ops.intersect import safe_inv_dir as jax_inv
from rayaccel_tpu.ops.trace_pallas import (_cull_and_queue,
                                           trace_mxu_pallas,
                                           trace_occlusion_pallas)
from rayaccel_tpu.ops.trace_sparse import trace_occlusion_sparse as jax_occl
from rayaccel_tpu.ops.trace_sparse import trace_sparse as jax_trace_sparse
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_battlefield_like, make_test_scene
from rayaccel_tpu.types import make_rays

from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.ops import trace_dense as dense
from rayaccel_tpu_torch.ops.trace_dense import trace_dense, trace_occlusion_dense
from rayaccel_tpu_torch.ops.trace_sparse import (trace_occlusion_sparse,
                                                 trace_sparse)

from tests.torch_helpers import port_rays, port_scene, random_rays

torch.set_num_threads(2)

N_RAYS = 2048


@pytest.fixture(scope="module")
def scenes():
    sd = make_test_scene()
    jcs = compile_clusters(sd, cluster_size=16)
    return sd, jcs, port_scene(jcs)


@pytest.fixture(scope="module")
def shadow_rays():
    """Scattered rays over [0, 20] with every fourth lane inactive (the
    inputs of tests/test_trace_mxu.py's occlusion cross-check)."""
    rays = random_rays(4321, n=N_RAYS, tmin=0.0, tmax=20.0)
    active = np.arange(N_RAYS) % 4 != 3
    return rays, active


def _jax_queue_overflow(jcs, rays, active, tile, k_step, tile_cap):
    """The clamp count of the JAX dense queue, which
    ``trace_occlusion_pallas`` computes and discards."""
    inv = jax_inv(rays.d)
    tmax_eff = jnp.where(jnp.asarray(active), rays.tmax, -1.0)
    return int(_cull_and_queue(
        jcs, tuple(rays.o[:, a] for a in range(3)),
        tuple(inv[:, a] for a in range(3)), rays.tmin, tmax_eff,
        rays.o.shape[0] // tile, tile, k_step=k_step, tile_cap=tile_cap)[3])


def test_dense_occlusion_matches_pallas(scenes, shadow_rays):
    _, jcs, cs = scenes
    rays, active = shadow_rays
    ref = np.asarray(trace_occlusion_pallas(jcs, rays,
                                            active=jnp.asarray(active),
                                            tile=512))
    occ, overflow = trace_occlusion_dense(cs, port_rays(rays),
                                          active=torch.tensor(active),
                                          tile=512)
    np.testing.assert_array_equal(occ.numpy(), ref)
    assert int(overflow) == _jax_queue_overflow(jcs, rays, active, 512, 4,
                                                256) == 0
    assert not occ[~torch.tensor(active)].any()
    assert 0.1 < occ.float().mean() < 0.9


def test_dense_occlusion_counts_clamp_overflow():
    """A queue clamp (k_step 4, tile_cap 4 over the test scene's 7 clusters
    of 8) drops each tile's farthest clusters. Both engines drop the same
    clusters, so the flags agree; the port counts the drop, which
    ``trace_occlusion_pallas`` discards (the decided difference)."""
    jcs = compile_clusters(make_test_scene(), cluster_size=8)
    cs = port_scene(jcs)
    assert cs.n_clusters > 4
    rays = random_rays(77, n=N_RAYS, tmin=0.0, tmax=20.0)
    active = np.ones(N_RAYS, bool)
    ref = np.asarray(trace_occlusion_pallas(jcs, rays, tile=512, k_step=4,
                                            tile_cap=4))
    occ, overflow = trace_occlusion_dense(cs, port_rays(rays), tile=512,
                                          k_step=4, tile_cap=4)
    np.testing.assert_array_equal(occ.numpy(), ref)
    assert int(overflow) == _jax_queue_overflow(jcs, rays, active, 512, 4,
                                                4) > 0
    full, ov_full = trace_occlusion_dense(cs, port_rays(rays), tile=512)
    assert int(ov_full) == 0
    assert (full & ~occ).any()      # the clamp lost some blockers


def test_dense_occlusion_plain_early_out_is_exact(scenes, shadow_rays):
    """K4's plain version with its per-tile early-out agrees with a full
    scan of every queued cluster (a bound that never stops)."""
    _, _, cs = scenes
    rays, active = shadow_rays
    r = port_rays(rays)
    F, q_cl, q_en, q_n, _ = dense._dense_inputs(
        cs, r, torch.tensor(active), 512, 4, 256)
    bb = dense.cluster_boxes(cs)
    got = dense.dense_occluded(F, cs.G3, q_cl, q_en, q_n, 512, boxes=bb)
    F_far = F.clone()
    F_far[:, 11] = torch.where(F[:, 11] > 0, 3e38, F[:, 11])
    everything = dense.dense_occluded_plain(F_far, cs.G3, q_cl, q_en, q_n,
                                            512, boxes=bb)
    # With tmax = 3e38 the window only grows, so the flags can only gain.
    assert not (got & ~everything).any()
    assert dense.dense_occluded.launches == 0     # CPU tensors: plain path


def test_sparse_occlusion_matches_jax(scenes, shadow_rays):
    _, jcs, cs = scenes
    rays, active = shadow_rays
    ref, under_ref = jax_occl(jcs, rays, active=jnp.asarray(active),
                              sp_tile=512)
    occ, under = trace_occlusion_sparse(cs, port_rays(rays),
                                        active=torch.tensor(active),
                                        sp_tile=512)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    assert int(under) == int(under_ref) == 0
    dense_occ, _ = trace_occlusion_dense(cs, port_rays(rays),
                                         active=torch.tensor(active),
                                         tile=512)
    np.testing.assert_array_equal(occ.numpy(), dense_occ.numpy())


def test_sparse_occlusion_tiny_k_multipass(scenes, shadow_rays):
    """With k = 1, unoccluded rays restart past their spill word until the
    window is exhausted, and end exactly where the dense engine does."""
    _, _, cs = scenes
    rays, active = shadow_rays
    occ, under = trace_occlusion_sparse(cs, port_rays(rays), k_pairs=1,
                                        sp_tile=512, max_passes=24)
    dense_occ, _ = trace_occlusion_dense(cs, port_rays(rays), tile=512)
    np.testing.assert_array_equal(occ.numpy(), dense_occ.numpy())
    assert int(under) == 0


def test_sparse_occlusion_under_resolved_is_counted():
    """At the pass cap, unresolved rays are reported unoccluded (never a
    phantom blocker) and counted: the counter covers every leak."""
    jcs = compile_clusters(make_battlefield_like(n_objects=40, grid=21),
                           cluster_size=16)
    cs = port_scene(jcs)
    lo = np.asarray(jcs.cl_bbmin).min(0)
    hi = np.asarray(jcs.cl_bbmax).max(0)
    rs = np.random.default_rng(11)
    o = rs.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    d = rs.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jr = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=1e-3, tmax=1e6)
    occ, under = trace_occlusion_sparse(cs, port_rays(jr), k_pairs=1,
                                        sp_tile=512, max_passes=1)
    exact, _ = trace_occlusion_dense(cs, port_rays(jr), tile=512)
    leaks = int((exact & ~occ).sum())
    assert not (occ & ~exact).any()
    assert leaks > 0 and int(under) >= leaks
    ref, under_ref = jax_occl(jcs, jr, k_pairs=1, sp_tile=512, max_passes=1)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    assert int(under) == int(under_ref)


@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_env_miss_rgb_matches_jax(scenes, engine):
    """``env=`` folds the environment's radiance into ``miss_rgb`` on the
    active rays that miss, and zero elsewhere."""
    sd, jcs, cs = scenes
    px = sd.env_pixels
    rays = random_rays(99, n=N_RAYS)
    active = np.arange(N_RAYS) % 5 != 0
    jenv = jax_env(px, px.shape[1], px.shape[0])
    env = create_environment(px, px.shape[1], px.shape[0], device="cpu")
    if engine == "dense":
        ref, _ = trace_mxu_pallas(jcs, rays, env=jenv,
                                  active=jnp.asarray(active), tile=512)
        res, _ = trace_dense(cs, port_rays(rays), env=env,
                             active=torch.tensor(active), tile=512)
    else:
        ref, _ = jax_trace_sparse(jcs, rays, env=jenv,
                                  active=jnp.asarray(active), sp_tile=512)
        res, _ = trace_sparse(cs, port_rays(rays), env=env,
                              active=torch.tensor(active), sp_tile=512)
    miss = (res.hits.tri.numpy() < 0) & (np.asarray(ref.hits.tri) < 0)
    both = miss & active
    assert both.sum() > 100
    got = res.hits.miss_rgb.numpy()
    np.testing.assert_allclose(got[both], np.asarray(ref.hits.miss_rgb)[both],
                               rtol=0, atol=1e-6)
    assert (got[both].max(axis=1) > 0).all()
    assert (got[~active] == 0).all()
    assert (got[res.hits.tri.numpy() >= 0] == 0).all()
