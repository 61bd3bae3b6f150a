"""The dense kernels' walk granularity and the context's device rule, on
the CPU.

K1 and K4 split a queue tile across CTAs, let each CTA keep the queued
clusters whose box one of its rays enters, and let each warp skip a kept
cluster none of its rays enters or whose entry passes every bound of its
rays; a ray takes a cluster's candidates only where it enters the box.
Their plain versions take the early-out group as ``group``. A cluster is
skipped only where it cannot change an answer, so every group size must
give the same output, bitwise, the closest hit over the queued clusters
each ray enters, and that output must still match the JAX package's
``trace_mxu_pallas`` / ``trace_occlusion_pallas`` (Pallas interpret mode)
within the tolerances of tests/test_torch_dense.py and
tests/test_torch_occlusion.py. The inputs are coherent camera primaries
whose tiles mix sky, hit and inactive lanes, and shadow rays cast from
their hits, on the test scene and on SPD tetra at size factor 4 (1,024
triangles: primaries through the pyramid's holes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayaccel_tpu.ops.trace_pallas import (trace_mxu_pallas,
                                           trace_occlusion_pallas)
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.data import SceneData
from rayaccel_tpu.scene.loader import make_test_scene
from rayaccel_tpu.types import make_rays

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch.ops import trace_dense as dense
from rtbench.scenes import spd_tetra

from tests.torch_helpers import (assert_agrees_with_jax, camera_rays,
                                 port_rays, port_scene)

torch.set_num_threads(2)

TILE = 512
GROUPS = [32, 128, TILE]
TETRA_SF = 4
TETRA_TRIANGLES = 4 ** (TETRA_SF + 1)


def _scene_data(kind):
    if kind == "test":
        return make_test_scene()
    return SceneData(**spd_tetra.generate(0, max_depth=2,
                                          size_factor=TETRA_SF,
                                          viewport=(64, 64)))


@pytest.fixture(scope="module", params=["test", "tetra"])
def scene(request):
    sd = _scene_data(request.param)
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
    bb = dense.cluster_boxes(cs)
    rays, active = primaries
    F, *q = _queue(cs, rays, active)
    hit = (dense.dense_closest_hit_plain(F, cs.G3, *q, TILE, boxes=bb)[1]
           >= 0)
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
    bb = dense.cluster_boxes(cs)
    F, *q = _queue(cs, *primaries)
    want = dense.dense_closest_hit_plain(F, cs.G3, *q, TILE, boxes=bb)
    got = dense.dense_closest_hit_plain(F, cs.G3, *q, TILE, boxes=bb,
                                        group=group)
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", GROUPS)
def test_occluded_walk_group_keeps_the_answer(scene, shadows, group):
    _, _, cs = scene
    bb = dense.cluster_boxes(cs)
    F, *q = _queue(cs, *shadows)
    want = dense.dense_occluded_plain(F, cs.G3, *q, TILE, boxes=bb)
    got = dense.dense_occluded_plain(F, cs.G3, *q, TILE, boxes=bb,
                                     group=group)
    assert torch.equal(got, want)


def test_closest_hit_is_the_nearest_over_the_boxes_each_ray_enters(
        scene, primaries):
    """The gated walk's words are, for each ray, the least packed score
    over the candidates of every queued cluster (up to its tile's count)
    whose box the ray enters, and that cluster's slot: what a walk with no
    early-out and no gate keeps once it masks each ray's boxes."""
    _, _, cs = scene
    F, q_cl, q_en, q_n = _queue(cs, *primaries)
    got = dense.dense_closest_hit_plain(F, cs.G3, q_cl, q_en, q_n, TILE,
                                        boxes=dense.cluster_boxes(cs))
    T = q_cl.shape[0]
    C = cs.cluster_size
    Ft = F.reshape(T, TILE, 16)
    inv = dense.safe_inv_dir(Ft[:, :, 0:3])
    best = Ft[:, :, 11].contiguous().view(torch.int32).clone()
    slot = torch.full_like(best, -1)
    col = torch.arange(C, dtype=torch.int32)
    for j in range(int(q_n.max())):
        cl = q_cl[:, j].long()
        t0, t1 = dense._slab(Ft[:, :, 3:6], inv, Ft[:, :, 10], Ft[:, :, 11],
                             cs.cl_bbmin[cl][:, None],
                             cs.cl_bbmax[cl][:, None])
        inside, ad, ts = dense._candidates(Ft[:, :, :10], cs.G3, cl)
        q = ts * torch.reciprocal(ad)
        score = torch.where(inside & (q > Ft[:, :, 10:11]), q,
                            torch.full_like(q, 3e38))
        m = ((score.view(torch.int32) & ~((1 << 7) - 1)) | col).amin(dim=2)
        better = (t0 <= t1) & (j < q_n)[:, None] & (m < best)
        slot = torch.where(better, cl[:, None].int() * C + (m & 127), slot)
        best = torch.where(better, m, best)
    assert torch.equal(got, torch.stack([best.reshape(-1),
                                         slot.reshape(-1)]))


@pytest.mark.parametrize("fn", ["closest_hit", "occluded"])
def test_walk_counts_what_the_gate_saves(scene, primaries, shadows, fn):
    """``walked`` gains the (ray, cluster) pairs the walk tested, whole
    groups of the kernel's warp, and the clusters its CTAs staged: both
    below the tile walk's rays x queue length and CTAs x queue length, on
    tetra's primaries (most of them through the holes) far below; a count
    leaves the words as they are."""
    sd, _, cs = scene
    rays, active = primaries if fn == "closest_hit" else shadows
    F, *q = _queue(cs, rays, active)
    plain = getattr(dense, f"dense_{fn}_plain")
    bb = dense.cluster_boxes(cs)
    walked = torch.zeros(2, dtype=torch.int64)
    got = plain(F, cs.G3, *q, TILE, boxes=bb, walked=walked)
    assert torch.equal(got, plain(F, cs.G3, *q, TILE, boxes=bb))
    pairs, staged = walked.tolist()
    rows = int(q[2].sum())
    assert pairs % dense.WARP_RAYS == 0
    assert 0 < pairs < TILE * rows
    assert 0 < staged < TILE // dense.CTA_RAYS * rows
    if fn == "closest_hit" and sd.triangle_count == TETRA_TRIANGLES:
        assert pairs < 0.25 * TILE * rows
        assert staged < 0.5 * TILE // dense.CTA_RAYS * rows


def test_closest_hit_walk_groups_match_pallas(scene, primaries):
    """On the test scene ``assert_agrees_with_jax`` holds. On tetra the
    faces a ray meets lie so close that the JAX engine's ranking noise
    (its reciprocal, a bf16 one in interpret mode) keeps a farther face
    for ~1-4% of the hits, before the gate as after it: there the hits
    agree exactly, t within the same bounds, and a winner differs only
    where JAX kept a face no more than 2^-7 farther than the port's."""
    sd, jcs, cs = scene
    bb = dense.cluster_boxes(cs)
    rays, active = primaries
    ref, _ = trace_mxu_pallas(jcs, rays, active=jnp.asarray(active),
                              tile=TILE)
    r = port_rays(rays)
    F, *q = _queue(cs, rays, active)
    for group in [dense.WARP_RAYS, *GROUPS]:
        slot = dense.dense_closest_hit_plain(F, cs.G3, *q, TILE, boxes=bb,
                                             group=group)[1]
        hit = slot >= 0
        _, tri, t, u, v = dense.reconstruct(cs, r, torch.where(hit, slot, 0))
        got = dense.make_hits(r, hit, tri, t, u, v)
        if sd.triangle_count != TETRA_TRIANGLES:
            assert_agrees_with_jax(got, ref.hits)
            continue
        h = hit.numpy()
        np.testing.assert_array_equal(h, np.asarray(ref.hits.tri) >= 0)
        t, tj = got.t.numpy()[h], np.asarray(ref.hits.t)[h]
        assert np.all(t <= tj * (1 + 1e-5) + 1e-5)
        assert np.all(tj <= t * (1 + 2.0 ** -7) + 1e-5)
        other = got.tri.numpy()[h] != np.asarray(ref.hits.tri)[h]
        assert np.all(t[other] < tj[other])


def test_occluded_walk_groups_match_pallas(scene, shadows):
    _, jcs, cs = scene
    bb = dense.cluster_boxes(cs)
    rays, active = shadows
    ref = np.asarray(trace_occlusion_pallas(jcs, rays,
                                            active=jnp.asarray(active),
                                            tile=TILE))
    assert 0 < ref.sum() < active.sum()
    F, *q = _queue(cs, rays, active)
    for group in [dense.WARP_RAYS, *GROUPS]:
        got = dense.dense_occluded_plain(F, cs.G3, *q, TILE, boxes=bb,
                                         group=group)
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
