"""The dense kernels' walk granularity and the context's device rule, on
the CPU.

K1 and K4 split a queue tile across CTAs and let each warp skip a queued
cluster whose entry passes every bound of its rays; their plain versions
take that early-out group as ``group``. A cluster is skipped only where it
cannot change an answer, so every group size must give the same output,
bitwise, and that output must still match the JAX package's
``trace_mxu_pallas`` / ``trace_occlusion_pallas`` (Pallas interpret mode)
within the tolerances of tests/test_torch_dense.py and
tests/test_torch_occlusion.py. The inputs are coherent camera primaries
whose tiles mix sky, hit and inactive lanes, and shadow rays cast from
their hits."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayaccel_tpu.ops.trace_pallas import (trace_mxu_pallas,
                                           trace_occlusion_pallas)
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene
from rayaccel_tpu.types import make_rays

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch.ops import trace_dense as dense

from tests.torch_helpers import (assert_agrees_with_jax, camera_rays,
                                 port_rays, port_scene)

torch.set_num_threads(2)

TILE = 512
GROUPS = [32, 128, TILE]


@pytest.fixture(scope="module")
def scene():
    sd = make_test_scene()
    jcs = compile_clusters(sd, cluster_size=16)
    return sd, jcs, port_scene(jcs)


@pytest.fixture(scope="module")
def primaries(scene):
    """The 64x64 pixel-centre camera rays with one lane in five inactive
    (numpy seed 5)."""
    rays = camera_rays(scene[0])
    active = np.random.default_rng(5).random(rays.o.shape[0]) >= 0.2
    return rays, active


@pytest.fixture(scope="module")
def shadows(scene, primaries):
    """Shadow rays over [1e-3, 20] from the primaries' hits toward a
    jittered light direction (numpy seed 6); active where the primary
    hit."""
    _, _, cs = scene
    rays, active = primaries
    res, _ = dense.trace_dense(cs, port_rays(rays),
                               active=torch.tensor(active), tile=TILE)
    hit = res.hits.tri.numpy() >= 0
    o = np.asarray(rays.o)
    o = np.where(hit[:, None], o + np.asarray(rays.d)
                 * res.hits.t.numpy()[:, None], o).astype(np.float32)
    d = np.random.default_rng(6).normal([0.4, 1.0, 0.3], 0.05, o.shape)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    srays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=1e-3, tmax=20.0)
    return srays, active & hit


def _queue(cs, rays, active):
    """(F, q_cluster, q_entry, q_count) of the dense engine at TILE."""
    return dense._dense_inputs(cs, port_rays(rays), torch.tensor(active),
                               TILE, dense.K_PER_STEP,
                               dense.DEFAULT_TILE_CAP)[:4]


def test_primary_tiles_mix_sky_hit_and_inactive_lanes(scene, primaries):
    _, _, cs = scene
    rays, active = primaries
    F, *q = _queue(cs, rays, active)
    hit = (dense.dense_closest_hit_plain(F, cs.G3, *q, TILE)[1] >= 0)
    hit = hit.reshape(-1, TILE).numpy()
    act = active.reshape(-1, TILE)
    mixed = (hit & act).any(1) & (~hit & act).any(1) & (~act).any(1)
    assert mixed.any()
    assert not (hit & ~act).any()


@pytest.mark.parametrize("group", GROUPS)
def test_closest_hit_walk_group_keeps_the_answer(scene, primaries, group):
    """K1's plain walk gives the same (2, R) words, bitwise, for every
    early-out group, as for the kernel's own (one warp's rays)."""
    _, _, cs = scene
    F, *q = _queue(cs, *primaries)
    want = dense.dense_closest_hit_plain(F, cs.G3, *q, TILE)
    got = dense.dense_closest_hit_plain(F, cs.G3, *q, TILE, group=group)
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", GROUPS)
def test_occluded_walk_group_keeps_the_answer(scene, shadows, group):
    _, _, cs = scene
    F, *q = _queue(cs, *shadows)
    want = dense.dense_occluded_plain(F, cs.G3, *q, TILE)
    got = dense.dense_occluded_plain(F, cs.G3, *q, TILE, group=group)
    assert torch.equal(got, want)


def test_closest_hit_walk_groups_match_pallas(scene, primaries):
    _, jcs, cs = scene
    rays, active = primaries
    ref, _ = trace_mxu_pallas(jcs, rays, active=jnp.asarray(active),
                              tile=TILE)
    r = port_rays(rays)
    F, *q = _queue(cs, rays, active)
    for group in [dense.WARP_RAYS, *GROUPS]:
        slot = dense.dense_closest_hit_plain(F, cs.G3, *q, TILE,
                                             group=group)[1]
        hit = slot >= 0
        _, tri, t, u, v = dense.reconstruct(cs, r, torch.where(hit, slot, 0))
        assert_agrees_with_jax(dense.make_hits(r, hit, tri, t, u, v),
                               ref.hits)


def test_occluded_walk_groups_match_pallas(scene, shadows):
    _, jcs, cs = scene
    rays, active = shadows
    ref = np.asarray(trace_occlusion_pallas(jcs, rays,
                                            active=jnp.asarray(active),
                                            tile=TILE))
    assert 0 < ref.sum() < active.sum()
    F, *q = _queue(cs, rays, active)
    for group in [dense.WARP_RAYS, *GROUPS]:
        got = dense.dense_occluded_plain(F, cs.G3, *q, TILE, group=group)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("trace_block", [64, 192, 320, 512, 1024])
def test_cuda_context_takes_a_tile_the_kernels_take(trace_block):
    """A CUDA context is built, without touching the card, for a queue tile
    that is a multiple of the dense kernels' CTA."""
    cfg = racc.Configuration(trace_block=trace_block)
    ctx = racc.create_context(cfg, device="cuda")
    assert ctx.device.type == "cuda"
    dense.check_tile(trace_block)


@pytest.mark.parametrize("tile", [0, 32, 96, 1000])
def test_dense_kernels_refuse_other_tiles(tile):
    """Such a tile is refused when a CUDA context is built, not first at a
    kernel's launch; the CPU's plain versions take it."""
    with pytest.raises(ValueError, match="multiple"):
        dense.check_tile(tile)
    if tile:
        cfg = racc.Configuration(trace_block=tile)
        with pytest.raises(ValueError, match="multiple"):
            racc.create_context(cfg, device="cuda")
        assert racc.create_context(cfg, device="cpu").configuration is cfg


def test_create_context_never_picks_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        racc.create_context()


def test_create_context_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = racc.create_context(racc.default_configuration(), device="cpu")
    assert ctx.device == torch.device("cpu")
