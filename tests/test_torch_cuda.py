"""Card-only checks of the port's hand-written kernels: each kernel, called
through its wrapper on CUDA tensors, against its plain version on the same
inputs, at test-scene size. A CUDA kernel has no CPU mode, so these skip
where no card is visible. On a machine with an NVIDIA Hopper GPU (no JAX
needed, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.camera import Camera, generate_pixel_rays
from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.ops import trace_dense as dense
from rayaccel_tpu_torch.ops import trace_sparse as sparse
from rayaccel_tpu_torch.render.whitted import shadow_rays
from rayaccel_tpu_torch.render.shading import surface_from_attrs
from rayaccel_tpu_torch.scene.clusters import (cluster_scene_from_numpy,
                                               compile_clusters_np,
                                               mma_fragments,
                                               select_chunk_boxes)
from rayaccel_tpu_torch.scene.data import SceneData
from rayaccel_tpu_torch.scene.loader import make_battlefield_like
from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate
from rayaccel_tpu_torch.types import make_rays
from rng_cases import EDGE_LANES, EDGE_PIXELS, KEYS, key, pixel_ids

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_data(cuda):
    return make_battlefield_like(n_objects=40, grid=21)


@pytest.fixture(scope="module")
def scenes(scene_data, cuda):
    arrays = compile_clusters_np(scene_data)
    return (cluster_scene_from_numpy(**arrays, device="cpu"),
            cluster_scene_from_numpy(**arrays, device=cuda))


def _rays(cs, n, seed, device):
    rs = np.random.default_rng(seed)
    lo, hi = (cs.cl_bbmin.amin(0).cpu().numpy(),
              cs.cl_bbmax.amax(0).cpu().numpy())
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return make_rays(torch.tensor(o, device=device),
                     torch.tensor(d, device=device), tmin=0.0, tmax=1e6)


def _same_hits(a, b):
    """Hit masks agree on >= 99.95% of rays; t within 1e-3 relative on
    >= 99.95% of common hits (the oracle bar of tools/oracle_lib.py)."""
    ha, hb = a.tri.cpu() >= 0, b.tri.cpu() >= 0
    assert (ha == hb).float().mean() >= 0.9995
    both = ha & hb
    rel = (a.t.cpu() - b.t.cpu()).abs() / b.t.cpu().clamp_min(1e-6)
    assert (rel[both] < 1e-3).float().mean() >= 0.9995


def test_dense_kernel_matches_plain(cuda, scenes):
    cpu_cs, gpu_cs = scenes
    launches = dense.dense_closest_hit.launches
    got, ov = dense.trace_dense(gpu_cs, _rays(cpu_cs, 8192, 1, cuda),
                                tile=1024)
    want, ov_p = dense.trace_dense(cpu_cs, _rays(cpu_cs, 8192, 1, "cpu"),
                                   tile=1024)
    assert dense.dense_closest_hit.launches == launches + 1
    assert int(ov) == int(ov_p)
    _same_hits(got.hits, want.hits)


@pytest.fixture(scope="module")
def queue_scenes(scene_data, scenes, cuda):
    """The test scene on the card in clusters of 128 (one box chunk of the
    cull kernel) and of 4 (436 clusters: four chunks, and more clusters
    than a tile_cap of 256)."""
    small = cluster_scene_from_numpy(
        **compile_clusters_np(scene_data, cluster_size=4), device=cuda)
    assert small.n_clusters > 256
    return {128: scenes[1], 4: small}


def _queue_inputs(rays, active):
    """The cull's inputs as ``_dense_inputs`` builds them."""
    tmax_eff = torch.where(active, rays.tmax, torch.full_like(rays.tmax, -1))
    return rays.o, dense.safe_inv_dir(rays.d), rays.tmin, tmax_eff


def _queue_case(kind, sd, cs, cuda):
    """(o, inv_d, tmin, tmax_eff, tiles of 64 that miss every box) of a ray
    set: coherent camera primaries, all active; the Whitted shadow rays of
    their hits; the primaries with one lane in five inactive, every third
    tile of 64 inactive and every fifth pointed away from the scene; or
    rays at random inside the scene's bounds, which enter most boxes."""
    if kind == "random":
        rays = _rays(cs, 16384, 21, cuda)
        return (*_queue_inputs(rays, torch.ones_like(rays.tmin, dtype=bool)),
                None)
    rays, active = _primaries(sd, 128, cuda)
    if kind == "camera":
        return (*_queue_inputs(rays, torch.ones_like(active)), None)
    if kind == "shadow":
        res, _ = dense.trace_dense(cs, rays, active=active, tile=1024)
        surf = surface_from_attrs(res.attrs, cs.mat_params, rays, res.hits)
        return (*_queue_inputs(shadow_rays(surf),
                               active & (res.hits.tri >= 0)), None)
    tiles = torch.arange(rays.o.shape[0], device=cuda) // 64
    active &= tiles % 3 != 0
    away = (tiles % 5 == 1) & (tiles % 3 != 0)
    # Below the scene's lowest corner, heading further down every axis.
    lo = cs.cl_bbmin.amin(0)
    d = torch.where(away[:, None], torch.full_like(rays.d, -1.0),
                    rays.d)
    rays = make_rays(torch.where(away[:, None], lo - 1.0, rays.o),
                     d / d.norm(dim=1, keepdim=True), tmin=0.0, tmax=1e6)
    return (*_queue_inputs(rays, active), away.reshape(-1, 64).all(1))


def _same_queue(got, want):
    """The kernel's queue equals the plain version's word for word, an
    entry of -0.0 aside (the kernel gives +0.0)."""
    want_entry = want[1].masked_fill(want[1] == -0x80000000, 0)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want_entry)
    assert torch.equal(got[2], want[2])
    assert got[3].dtype == torch.int64 and int(got[3]) == int(want[3])


@pytest.mark.parametrize("cluster_size", [128, 4])
@pytest.mark.parametrize("tile", [64, 512, 1024])
@pytest.mark.parametrize("kind", ["camera", "shadow", "inactive", "random"])
def test_queue_kernel_matches_plain(cuda, scene_data, queue_scenes, kind,
                                    tile, cluster_size):
    """The cull and queue kernel against ``cull_and_queue_plain`` on the
    same inputs, in each (k_step, tile_cap) of the JAX comparison
    (test_torch_dense.py::test_queue_matches_pallas_queue): the clamp
    binds at the small caps, and at 256 on the random rays of the scene
    in clusters of 4 in tiles of 1,024."""
    cs = queue_scenes[cluster_size]
    o, inv, tmin, tmax_eff, away = _queue_case(kind, scene_data, cs, cuda)
    T = o.shape[0] // tile
    for K, cap in ((4, 4), (4, 256), (1, 2)):
        launches = dense.cull_and_queue.launches
        got = dense.cull_and_queue(cs, o, inv, tmin, tmax_eff, T, tile, K,
                                   cap)
        want = dense.cull_and_queue_plain(cs, o, inv, tmin, tmax_eff, T,
                                          tile, K, cap)
        assert dense.cull_and_queue.launches == launches + 1
        _same_queue(got, want)
        if away is not None and tile == 64:
            # Tiles that miss every box, or hold no active lane, queue
            # cluster 0 alone.
            empty = away | (torch.arange(T, device=cuda) % 3 == 0)
            assert (got[0][empty] == 0).all()
            assert (got[2][empty] == min(K, cap)).all()
        if kind == "random" and cluster_size == 4 and tile == 1024:
            assert int(got[3]) > 0


def test_queue_kernel_takes_tile_caps_up_to_its_limit(cuda, scene_data,
                                                      scenes):
    _, cs = scenes
    rays, active = _primaries(scene_data, 32, cuda)
    a = (cs, *_queue_inputs(rays, active), 1, 1024)
    _same_queue(dense.cull_and_queue(*a, 4, dense.QUEUE_MAX_CAP),
                dense.cull_and_queue_plain(*a, 4, dense.QUEUE_MAX_CAP))
    with pytest.raises(ValueError, match="tile_cap"):
        dense.cull_and_queue(*a, 4, dense.QUEUE_MAX_CAP + 4)


@pytest.mark.parametrize("tile", [64, 1024])
def test_dense_kernels_on_the_queue_kernel(cuda, scenes, scene_data, tile):
    """K1 and K4 give the same words on the kernel's queue as on the plain
    version's."""
    _, cs = scenes
    bb = dense.cluster_boxes(cs)
    rays, active = _primaries(scene_data, 128, cuda)
    F, q_k, q_k_entry, q_k_count, _ = dense._dense_inputs(
        cs, rays, active, tile, dense.K_PER_STEP, dense.DEFAULT_TILE_CAP)
    T = F.shape[0] // tile
    q_p = dense.cull_and_queue_plain(cs, *_queue_inputs(rays, active), T,
                                     tile)[:3]
    out = dense.dense_closest_hit(F, cs.G3, q_k, q_k_entry, q_k_count, tile,
                                  boxes=bb)
    assert torch.equal(out,
                       dense.dense_closest_hit(F, cs.G3, *q_p, tile,
                                               boxes=bb))
    hit = out[1] >= 0
    attr, tri, t, u, v = dense.reconstruct(cs, rays,
                                           torch.where(hit, out[1], 0))
    surf = surface_from_attrs(attr, cs.mat_params, rays,
                              dense.make_hits(rays, hit, tri, t, u, v))
    srays, sactive = shadow_rays(surf), active & hit
    F4, *q4_k, _ = dense._dense_inputs(cs, srays, sactive, tile,
                                       dense.K_PER_STEP,
                                       dense.DEFAULT_TILE_CAP)
    q4_p = dense.cull_and_queue_plain(cs, *_queue_inputs(srays, sactive), T,
                                      tile)[:3]
    occ = dense.dense_occluded(F4, cs.G3, *q4_k, tile, boxes=bb)
    assert occ.any() and not occ.all()
    assert torch.equal(occ, dense.dense_occluded(F4, cs.G3, *q4_p, tile,
                                                     boxes=bb))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_select_kernel_bitwise(cuda, scenes, k):
    cpu_cs, gpu_cs = scenes
    r = _rays(cpu_cs, 8192, k, "cpu")
    tmax = torch.where(torch.arange(8192) % 7 == 0, -1.0, r.tmax)
    tmax[:1024] = -1.0
    out = sparse._select(cpu_cs, r.o, 1 / r.d, r.tmin, tmax, k)
    prev = out[2]
    got = sparse._select(gpu_cs, r.o.to(cuda), (1 / r.d).to(cuda),
                         r.tmin.to(cuda), tmax.to(cuda), k, prev.to(cuda))
    want = sparse._select(cpu_cs, r.o, 1 / r.d, r.tmin, tmax, k, prev)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_pair_kernel_matches_plain(cuda, scenes):
    cpu_cs, gpu_cs = scenes
    got, ov = sparse.trace_sparse(gpu_cs, _rays(cpu_cs, 8192, 2, cuda))
    want, ov_p = sparse.trace_sparse(cpu_cs, _rays(cpu_cs, 8192, 2, "cpu"))
    assert sparse.pair_hit.launches > 0
    assert abs(int(ov) - int(ov_p)) <= 4
    _same_hits(got.hits, want.hits)


def _shadow_rays(cs, n, seed, device):
    """Rays over [1e-3, 20] with every fourth lane inactive."""
    r = _rays(cs, n, seed, device)
    r = r._replace(tmin=torch.full_like(r.tmin, 1e-3),
                   tmax=torch.full_like(r.tmax, 20.0))
    return r, torch.arange(n, device=device) % 4 != 3


def test_occlusion_kernel_matches_plain(cuda, scenes):
    """K4 through trace_occlusion_dense: one launch, the same overflow, and
    the same flags on >= 99.95% of rays (K4 and the plain version's matrix
    product may round the dot products differently at a triangle edge)."""
    cpu_cs, gpu_cs = scenes
    launches = dense.dense_occluded.launches
    r, active = _shadow_rays(cpu_cs, 8192, 3, cuda)
    got, ov = dense.trace_occlusion_dense(gpu_cs, r, active=active,
                                          tile=1024)
    r_c, active_c = _shadow_rays(cpu_cs, 8192, 3, "cpu")
    want, ov_p = dense.trace_occlusion_dense(cpu_cs, r_c, active=active_c,
                                             tile=1024)
    assert dense.dense_occluded.launches == launches + 1
    assert int(ov) == int(ov_p)
    assert (got.cpu() == want).float().mean() >= 0.9995
    assert want.any() and not got[~active].any()


def test_sparse_occlusion_on_card_matches_cpu(cuda, scenes):
    """trace_occlusion_sparse on the card (K2, and K3 with its tmax guard)
    against the same query on the CPU."""
    cpu_cs, gpu_cs = scenes
    launches = sparse.pair_hit.launches
    r, active = _shadow_rays(cpu_cs, 8192, 4, cuda)
    got, under = sparse.trace_occlusion_sparse(gpu_cs, r, active=active)
    r_c, active_c = _shadow_rays(cpu_cs, 8192, 4, "cpu")
    want, under_p = sparse.trace_occlusion_sparse(cpu_cs, r_c,
                                                  active=active_c)
    assert sparse.pair_hit.launches > launches
    assert abs(int(under) - int(under_p)) <= 4
    assert (got.cpu() == want).float().mean() >= 0.9995
    assert want.any()


def test_launch_validates_arguments(cuda, scenes):
    """A CUDA launch checks its arguments and raises; it never falls back
    to the plain version."""
    _, gpu_cs = scenes
    Fp = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="items"):
        sparse.pair_hit(Fp, gpu_cs.G3,
                        torch.zeros((1, 3), dtype=torch.int64, device=cuda),
                        7, False)
    with pytest.raises(ValueError, match="items"):
        sparse.pair_hit(Fp, gpu_cs.G3,
                        torch.zeros((1, 2), dtype=torch.int32, device=cuda),
                        7, False)
    with pytest.raises(ValueError, match="G3"):
        sparse.pair_hit(Fp, gpu_cs.G3[:, :, :10].contiguous(),
                        torch.zeros((1, 3), dtype=torch.int32, device=cuda),
                        7, False)
    lanes = (torch.zeros((8, 8), device=cuda),
             torch.zeros(8, dtype=torch.int32, device=cuda),
             torch.ones(8, dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError, match="takes 1 to"):
        sparse.select_nearest(*lanes, torch.zeros(((1 << 20) + 1, 6),
                                                  device=cuda), 4, 21)
    with pytest.raises(ValueError, match="id_bits"):
        sparse.select_nearest(*lanes, torch.zeros((1 << 14, 6), device=cuda),
                              4, 13)
    many = torch.zeros((1 << 14, 6), device=cuda)
    with pytest.raises(ValueError, match="union box"):
        sparse.select_nearest(*lanes, many, 4, 14)
    with pytest.raises(ValueError, match="chunk_boxes"):
        sparse.select_nearest(*lanes, many, 4, 14,
                              chunk_boxes=torch.zeros((4, 6), device=cuda))
    assert sparse.select_nearest(
        *lanes, many, 4, 14,
        chunk_boxes=select_chunk_boxes(many)).shape == (6, 8)


def _restart_select_inputs(cs, R, seed):
    """K2's arguments for a restart-style launch of R lanes, on the CPU:
    scattered rays whose last third is dead padding, with warps and single
    lanes of dead rays inside live tiles and a few empty windows with both
    ends positive; prev is a first pass's spill words (k = 4)."""
    r = _rays(cs, R, seed, "cpu")
    lane = torch.arange(R)
    tmin = r.tmin.clone()
    tmax = torch.where(lane % 7 == 0, -1.0, r.tmax)
    tmax[(lane // 64) % 3 == 1] = -1.0           # whole warps dead
    tmax[R - R // 3:] = -1.0                     # padding lanes
    tmin[5:R:97], tmax[5:R:97] = 6.0, 2.0
    tmax[1024:2048] = -1.0                       # a dead select tile
    n_cp = cs.bb.shape[0]
    id_bits = max((n_cp - 1).bit_length(), 1)
    tile = sparse._select_tile(R, n_cp)
    live = ((tmax > 0).reshape(-1, tile).any(dim=1).repeat_interleave(tile)
            .to(torch.uint8))
    F8 = torch.cat([r.o, 1 / r.d, tmin[:, None], tmax[:, None]], dim=1)
    none = torch.full((R,), -0x80000000, dtype=torch.int32)
    prev = sparse.select_nearest_plain(F8, none, live, cs.bb, 4,
                                       id_bits)[4].contiguous()
    return F8, prev, live, cs.bb, id_bits


def _on(device, *tensors):
    return tuple(t.to(device) for t in tensors)


@pytest.mark.parametrize("R", [1024, 4096, 65536])
def test_select_kernel_bitwise_at_launch_widths(cuda, scenes, R):
    """K2 at the widths of the bounce loop's restart passes, at the split
    its launcher picks: bitwise equal to the plain version, and only the
    lanes that are neither in a dead tile nor dead ran the box loop."""
    cpu_cs, _ = scenes
    F8, prev, live, bb, id_bits = _restart_select_inputs(cpu_cs, R, R)
    need = int(((live == 1) & ~(F8[:, 7] < F8[:, 6])).sum())
    assert 0 < need < R and (R == 1024 or (live == 0).any())
    assert sparse.select_split(R) > sparse.select_split(1 << 20) == 1
    for k in (4, 8):
        want = sparse.select_nearest_plain(F8, prev, live, bb, k, id_bits)
        tested = torch.zeros(1, dtype=torch.int64, device=cuda)
        got = sparse.select_nearest(*_on(cuda, F8, prev, live, bb), k,
                                    id_bits, tested=tested)
        assert torch.equal(got.cpu(), want)
        assert int(tested) == need


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16, 32])
def test_select_kernel_bitwise_at_every_split(cuda, scenes, split):
    """Every split the launcher can pick, forced, on all the boxes and on
    the first 13 (fewer boxes than threads on a lane, and than k + 1 on
    each)."""
    cpu_cs, _ = scenes
    F8, prev, live, bb, id_bits = _restart_select_inputs(cpu_cs, 4096, split)
    for boxes in (bb, bb[:13].contiguous()):
        for k in (1, 3, 4, 6, 8):
            want = sparse.select_nearest_plain(F8, prev, live, boxes, k,
                                               id_bits)
            got = sparse._launch_select(*_on(cuda, F8, prev, live, boxes), k,
                                        id_bits, split, None)
            assert torch.equal(got.cpu(), want)


@pytest.fixture(scope="module")
def tetra_boxes(cuda):
    """SPD tetra at size factor 8 (262,144 triangles) in clusters of 8: its
    first 32,768 boxes, in the BVH cut's order, on the CPU."""
    from rtbench.scenes import spd_tetra
    sd = SceneData(**spd_tetra.generate(0, max_depth=2, size_factor=8,
                                        viewport=(64, 32)))
    bb = cluster_scene_from_numpy(**compile_clusters_np(sd, cluster_size=8),
                                  device="cpu").bb
    assert bb.shape[0] >= 32768
    return sd, bb[:32768].contiguous()


def _select_case(sd, kind, R=2048):
    """(F8, live) of R lanes in select tiles of 256: ``camera``, the
    scene camera's rays through a 64 x 32 grid of the view (coherent), or
    ``random``, origins inside the pyramid's cube in every direction; a
    dead select tile, scattered dead lanes and empty windows in both."""
    rs = np.random.default_rng(7)
    if kind == "camera":
        cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                             sd.cam_fov, 64, 32)
        y, x = np.divmod(np.arange(R), 64)
        d = (cam.view[None] + (x[:, None] + 0.5) * cam.right[None]
             + (y[:, None] + 0.5) * cam.up[None])
        o = np.broadcast_to(cam.origin, (R, 3))
    else:
        o = rs.uniform(-1, 1, (R, 3))
        d = rs.normal(size=(R, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = torch.zeros(R)
    tmax = torch.full((R,), 1e6)
    tmax[256:512] = -1.0
    tmax[torch.tensor(rs.random(R) < 0.2)] = -1.0
    tmin[100:110], tmax[100:110] = 5.0, 2.0
    live = ((tmax > 0).reshape(-1, 256).any(dim=1).repeat_interleave(256)
            .to(torch.uint8))
    F8 = torch.cat([torch.tensor(o, dtype=torch.float32),
                    dense.safe_inv_dir(torch.tensor(d, dtype=torch.float32)),
                    tmin[:, None], tmax[:, None]], dim=1)
    return F8, live


@pytest.mark.parametrize("n_cp", [128, 9216, 9344, 32768])
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_select_kernel_bitwise_past_one_cta(cuda, tetra_boxes, kind, n_cp):
    """K2 against its plain version, bit for bit, on n_cp boxes at k 1, 4
    and 8, every split, with and without the count, on a first pass and on
    a restart pass. With 9,216 boxes or fewer it takes the single-chunk
    path: ``tested`` counts each lane that ran the box loop once, where
    chunks of 2,048 would count another number. Past them it streams the boxes in
    chunks: ``tested`` counts the (lane, chunk) pairs that
    ``select_chunks_needed`` counts with the count, and no more without
    it."""
    sd, boxes = tetra_boxes
    bb = boxes[:n_cp].contiguous()
    id_bits = max((n_cp - 1).bit_length(), 1)
    F8, live = _select_case(sd, kind)
    need = int(((live == 1) & ~(F8[:, 7] < F8[:, 6])).sum())
    ub = select_chunk_boxes(bb)
    first = torch.full((F8.shape[0],), -0x80000000, dtype=torch.int32)
    spill = sparse.select_nearest_plain(F8, first, live, bb, 4, id_bits)[4]
    if n_cp == 9216:
        assert sparse.select_chunks_needed(F8, first, live, ub,
                                           id_bits) != need
    for prev in (first, spill.contiguous()):
        pairs = sparse.select_chunks_needed(F8, prev, live, ub, id_bits)
        for k in (1, 4, 8):
            want = sparse.select_nearest_plain(F8, prev, live, bb, k, id_bits)
            for split in (1, 2, 4, 8, 16, 32):
                for count in (True, False):
                    tested = torch.zeros(1, dtype=torch.int64, device=cuda)
                    got = sparse._launch_select(
                        *_on(cuda, F8, prev, live, bb), k, id_bits, split,
                        tested, ub.to(cuda), count)
                    assert torch.equal(got.cpu(),
                                       want if count else want[:k + 1])
                    if n_cp <= 9216:
                        assert int(tested) == need
                    else:
                        assert (int(tested) == pairs if count
                                else int(tested) <= pairs)


def test_select_kernel_skips_chunks_on_coherent_rays(cuda, tetra_boxes):
    """On the camera's rays the chunked path skips most (lane, chunk)
    pairs, and more without the count; on random rays inside the pyramid
    it skips fewer. Either way the words are the plain version's (the test
    above), so no chunk was skipped wrongly."""
    sd, bb = tetra_boxes
    n_chunks = -(-bb.shape[0] // 2048)
    share = {}
    for kind in ("camera", "random"):
        F8, live = _select_case(sd, kind)
        need = int(((live == 1) & ~(F8[:, 7] < F8[:, 6])).sum())
        args = (*_on(cuda, F8, torch.full((F8.shape[0],), -0x80000000,
                                          dtype=torch.int32), live, bb),)
        ub = select_chunk_boxes(bb).to(cuda)
        got = []
        for count in (True, False):
            tested = torch.zeros(1, dtype=torch.int64, device=cuda)
            sparse.select_nearest(*args, 4, 15, tested=tested, chunk_boxes=ub,
                                  count=count)
            got.append(int(tested))
        assert 0 < got[1] <= got[0] <= need * n_chunks
        share[kind] = got[0] / (need * n_chunks)
    assert share["camera"] < 0.5 and share["camera"] < share["random"]


def _pair_case(cs, R, seed, device):
    """Pairs of a k = 8 pass over R scattered rays, as _sparse_pass builds
    them at SP = 512, and the same runs cut into items of 1-5 pairs."""
    r = _rays(cs, R, seed, device)
    tmax = torch.full_like(r.tmax, 9.0)
    lat_valid, lat_id, _ = sparse._select(cs, r.o, 1 / r.d, r.tmin, tmax, 8)
    cl, ray, rank, _ = sparse._lattice_pairs(lat_valid, lat_id, 8 * R)
    Fp, items = sparse._pair_inputs(r.o, r.d, r.tmin, tmax, cl, ray, rank,
                                    512)
    rs = np.random.default_rng(seed)
    cuts = []
    for s, e, c in items.tolist():
        while s < e:
            n = min(int(rs.integers(1, 6)), e - s)
            cuts.append((s, s + n, c))
            s += n
    short = torch.tensor(cuts, dtype=torch.int32, device=device)
    return Fp, items, short


def _same_words(got, want, low):
    """Packed pair words at the oracle bar: hit or miss agrees on >= 99.95%
    of pairs and the score (the word without its rank and column bits) is
    within 1e-3 relative on >= 99.95% of common hits."""
    hg, hw = got < sparse._MISS_BITS, want < sparse._MISS_BITS
    assert hw.any() and not hw.all()
    assert (hg == hw).float().mean() >= 0.9995
    both = hg & hw
    tg = (got & ~low).view(torch.float32)[both]
    tw = (want & ~low).view(torch.float32)[both]
    assert (((tg - tw).abs() / tw.clamp_min(1e-6)) < 1e-3).float().mean() \
        >= 0.9995


@pytest.mark.parametrize("guard_tmax", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("R", [1024, 4096, 65536])
def test_pair_kernel_matches_plain_at_launch_widths(cuda, scenes, R,
                                                    guard_tmax):
    """K3 against its plain version (both on the card) on runs longer than
    one work unit, a cluster on both sides of an SP boundary, and the same
    pairs as items of 1-5; the counters report every unit and at most one
    staging a unit."""
    _, cs = scenes
    Fp, items, short = _pair_case(cs, R, R, cuda)
    runs = items[:, 1] - items[:, 0]
    if R > 1024:
        assert (runs > 64).any()
        assert ((items[1:, 2] == items[:-1, 2])
                & (items[1:, 0] % 512 == 0)).any()
    assert ((short[:, 1] - short[:, 0]) <= 5).all()
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    low = (1 << (col_bits + 3)) - 1
    want = sparse.pair_hit_plain(Fp, cs.G3, items, col_bits, guard_tmax)
    for it in (items, short):
        stats = torch.zeros(3, dtype=torch.int64, device=cuda)
        got = sparse.pair_hit(Fp, cs.G3, it, col_bits, guard_tmax,
                              stats=stats)
        _same_words(got, want, low)
        units, ctas, staged = stats.tolist()
        assert units == int(((it[:, 1] - it[:, 0] + 63) // 64).sum())
        assert 0 < ctas <= units and ctas <= staged <= units
    part = sparse.pair_hit(Fp, cs.G3, items[::2].contiguous(), col_bits,
                           guard_tmax)
    covered = torch.zeros(Fp.shape[0], dtype=torch.bool, device=cuda)
    for s, e, _ in items[::2].tolist():
        covered[s:e] = True
    assert torch.equal(part[covered], sparse.pair_hit(
        Fp, cs.G3, items, col_bits, guard_tmax)[covered])
    assert (part[~covered] == sparse._MISS_BITS).all()


def test_pair_kernel_matches_plain_on_small_clusters(cuda, scene_data):
    """K3 on clusters of 16 triangles (a ring stage of 3 KB)."""
    cs = cluster_scene_from_numpy(
        **compile_clusters_np(scene_data, cluster_size=16), device=cuda)
    Fp, items, short = _pair_case(cs, 4096, 7, cuda)
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    want = sparse.pair_hit_plain(Fp, cs.G3, items, col_bits, False)
    for it in (items, short):
        _same_words(sparse.pair_hit(Fp, cs.G3, it, col_bits, False), want,
                    (1 << (col_bits + 3)) - 1)


def test_pair_kernel_without_items_writes_misses(cuda, scenes):
    _, cs = scenes
    Fp, items, _ = _pair_case(cs, 1024, 3, cuda)
    launches = sparse.pair_hit.launches
    out = sparse.pair_hit(Fp, cs.G3, items[:0], 7, False)
    assert sparse.pair_hit.launches == launches
    assert out.shape == (Fp.shape[0],) and (out == sparse._MISS_BITS).all()


def _primaries(sd, n, device):
    """Coherent pixel-centre camera rays of an n x n image of the scene,
    with one lane in five inactive (numpy seed 5)."""
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         n, n)
    yy, xx = np.mgrid[0:n, 0:n]
    rays = generate_pixel_rays(cam.as_arrays(device),
                               torch.tensor(xx.ravel(), device=device),
                               torch.tensor(yy.ravel(), device=device))
    active = np.random.default_rng(5).random(n * n) >= 0.2
    return rays, torch.tensor(active, device=device)


def _dense_case(cs, rays, active, tile, pad):
    """The dense inputs at ``tile``; with ``pad`` every queue row counts
    to tile_cap, its tail the farthest cluster repeated."""
    F, q_cl, q_en, q_n, _ = dense._dense_inputs(cs, rays, active, tile,
                                                dense.K_PER_STEP,
                                                dense.DEFAULT_TILE_CAP)
    if pad:
        q_n = torch.full_like(q_n, dense.DEFAULT_TILE_CAP)
    return F, cs.G3, q_cl, q_en, q_n, tile


@pytest.mark.parametrize("pad", [False, True], ids=["queue", "padded"])
@pytest.mark.parametrize("tile", [64, 512, 1024])
def test_dense_kernels_match_plain_on_mixed_primaries(cuda, scenes,
                                                       scene_data, tile,
                                                       pad):
    """K1 and K4 against their plain versions on coherent primaries whose
    tiles mix sky, hit and inactive lanes, and on shadow rays from their
    hits: hits and winners at the oracle bar, flags on >= 99.95% of rays
    (the kernels' dot products round apart from the plain versions'
    matrix products at a triangle edge)."""
    _, cs = scenes
    rays, active = _primaries(scene_data, 128, cuda)
    bb = dense.cluster_boxes(cs)
    a1 = _dense_case(cs, rays, active, tile, pad)
    got = dense.dense_closest_hit(*a1, boxes=bb)
    want = dense.dense_closest_hit_plain(*a1, boxes=bb)
    hit = want[1] >= 0
    mixed = ((hit & active).reshape(-1, tile).any(1)
             & (~hit & active).reshape(-1, tile).any(1)
             & (~active).reshape(-1, tile).any(1))
    assert mixed.any()
    assert ((got[1] >= 0) == hit).float().mean() >= 0.9995
    both = hit & (got[1] >= 0)
    assert (got[1] == want[1])[both].float().mean() >= 0.9995
    assert (got[0] == want[0])[both].float().mean() >= 0.9995

    attr, tri, t, u, v = dense.reconstruct(cs, rays,
                                           torch.where(hit, want[1], 0))
    surf = surface_from_attrs(attr, cs.mat_params, rays,
                              dense.make_hits(rays, hit, tri, t, u, v))
    a4 = _dense_case(cs, shadow_rays(surf), active & hit, tile, pad)
    occ = dense.dense_occluded(*a4, boxes=bb)
    occ_p = dense.dense_occluded_plain(*a4, boxes=bb)
    assert occ_p.any() and not occ_p.all()
    assert (occ == occ_p).float().mean() >= 0.9995


def test_dense_kernels_refuse_a_tile_they_do_not_take(cuda, scenes,
                                                      scene_data):
    _, cs = scenes
    rays, active = _primaries(scene_data, 32, cuda)
    a = _dense_case(cs, rays, active, 32, False)
    with pytest.raises(ValueError, match="multiple"):
        dense.dense_closest_hit(*a, boxes=dense.cluster_boxes(cs))
    with pytest.raises(ValueError, match="multiple"):
        dense.dense_occluded(*a, boxes=dense.cluster_boxes(cs))


def test_trace_mxu_matches_dense_on_the_card(cuda, scenes):
    """The plain cluster engine (``torch.bmm`` at fp32, TF32 off) against
    the dense work-queue engine (K1) on the same rays on the card, and its
    any-hit form against K4, by the oracle bar."""
    from rayaccel_tpu_torch.context import init
    from rayaccel_tpu_torch.ops.trace_mxu import (trace_mxu,
                                                  trace_occlusion_mxu)
    init()
    cpu_cs, gpu_cs = scenes
    rays = _rays(cpu_cs, 8192, 13, cuda)
    active = torch.arange(8192, device=cuda) % 5 != 0
    launches = dense.dense_closest_hit.launches
    got = trace_mxu(gpu_cs, rays, active=active, tile=1024)
    assert dense.dense_closest_hit.launches == launches    # no kernel of ours
    want, ov = dense.trace_dense(gpu_cs, rays, active=active, tile=1024)
    assert int(ov) == 0 and got.hits.tri.device.type == "cuda"
    _same_hits(got.hits, want.hits)
    assert bool((got.hits.tri[~active] == -1).all())
    short = make_rays(rays.o, rays.d, tmin=1e-3, tmax=8.0)
    occ = trace_occlusion_mxu(gpu_cs, short, active=active, tile=1024)
    occ_k4, ov = dense.trace_occlusion_dense(gpu_cs, short, active=active,
                                             tile=1024)
    assert int(ov) == 0
    assert (occ == occ_k4).float().mean() >= 0.9995
    assert 0 < int(occ.sum()) < int(active.sum())


CLI_SMALL = ["--synthetic", "test", "--width", "64", "--height", "64",
             "--wave-size", "4096", "--max-depth", "2", "--quiet"]


def _launch_counts():
    return [fn.launches for fn in (dense.dense_closest_hit,
                                   sparse.select_nearest, sparse.pair_hit)]


def test_cli_writes_a_finite_image_on_the_card(cuda, tmp_path):
    """The CLI with no --device renders on the current CUDA device through
    K1, K2 and K3 and writes a finite image that is not black."""
    from rayaccel_tpu_torch import cli
    out = tmp_path / "t.pfm"
    before = _launch_counts()
    assert cli.main(CLI_SMALL + ["--spp", "2", "--out", str(out)]) == 0
    assert all(a > b for a, b in zip(_launch_counts(), before))
    with open(out, "rb") as f:
        assert f.readline().strip() == b"PF"
        assert f.readline().split() == [b"64", b"64"]
        f.readline()
        img = np.fromfile(f, np.float32)
    assert img.size == 64 * 64 * 3
    assert np.isfinite(img).all() and img.max() > 0


def test_cli_resume_is_bitwise_on_the_card(cuda, tmp_path):
    """A render resumed from a checkpoint with another --seed equals the
    render with no break, bit for bit, on the default engines."""
    from rayaccel_tpu_torch import cli
    a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    ck = str(tmp_path / "ck")
    assert cli.main(CLI_SMALL + ["--spp", "3", "--seed", "5", "--out", a]) == 0
    assert cli.main(CLI_SMALL + ["--spp", "1", "--seed", "5", "--checkpoint",
                                 ck, "--out", str(tmp_path / "x.pfm")]) == 0
    assert cli.main(CLI_SMALL + ["--spp", "3", "--seed", "999",
                                 "--checkpoint", ck, "--out", b]) == 0
    np.testing.assert_array_equal(np.fromfile(a, np.float32),
                                  np.fromfile(b, np.float32))


def test_profile_stages_on_the_card(cuda):
    """Four stages (the JAX function's less its regroup), each timed by
    CUDA events and positive."""
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.scene.loader import make_test_scene
    from rayaccel_tpu_torch.utils.profiling import profile_stages
    s = make_test_scene(viewport=(64, 64), max_depth=2)
    ctx = racc.create_context(racc.Configuration(wave_size=4096),
                              device=cuda)
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                              64, 64)
    r = racc.PathTracingRenderer(ctx, cam, s)
    r.render_frame(rng.PRNGKey(0))
    out = profile_stages(r, iters=3)
    assert set(out) == {"primary_trace_ms", "bounce_trace_ms", "shade_ms",
                        "env_sample_ms"}
    assert all(np.isfinite(v) and v > 0 for v in out.values()), out


def test_mesh1_frame_on_the_card_matches_the_cpu_mesh(cuda, scenes,
                                                     scene_data):
    """A 64x64 path-traced frame under a one-rank mesh on the card (an NCCL
    group) against the same frame under a one-rank mesh on the CPU (gloo),
    the same key, through the two-class gate of
    ``tools/oracle_lib.py:run_image_oracle``."""
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    sd = type(scene_data)(**{**scene_data.__dict__, "viewport_width": 64,
                             "viewport_height": 64, "max_depth": 2})
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 64, 64)
    images = []
    try:
        for device, cs, backend in ((cuda, scenes[1], "nccl"),
                                    ("cpu", scenes[0], "gloo")):
            ctx = racc.create_context(racc.Configuration(
                mesh_shape=(1,), wave_size=4096, trace_block=512),
                device=device)
            assert (ctx.mesh.size, ctx.mesh.backend) == (1, backend)
            r = racc.PathTracingRenderer(ctx, cam, sd, tpu_scene=cs)
            r.render_frame(rng.PRNGKey(3))
            assert r.dropped == 0
            images.append(r.image().reshape(-1, 3))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    gate = two_class_gate(images[0], images[1])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    assert np.isfinite(images[0]).all() and images[0].max() > 0


@pytest.mark.parametrize("cluster_size", [6, 16, 128])
def test_bf16_kernels_match_plain(cuda, scene_data, cluster_size):
    """The bf16 tensor-core variants of K1, K4 and K3 (precision "default")
    against the plain versions at "default" on the card, on clusters of 6
    (a last group of 4 triangles that runs past the cluster), 16 and 128:
    K1 and K3 at the oracle bar, K4's flags on >= 99.95% of rays. Each
    launch counts as a bf16 launch; the fp32 forms do not run. The three
    read the scene's fragment copy, and K1's and K4's plain versions walk
    in the kernels' group."""
    cs = cluster_scene_from_numpy(
        **compile_clusters_np(scene_data, cluster_size=cluster_size),
        device=cuda)
    counted = (dense.dense_closest_hit, dense.dense_occluded, sparse.pair_hit)
    before = [(fn.launches, fn.launches_bf16) for fn in counted]
    rays, active = _primaries(scene_data, 128, cuda)
    a1 = _dense_case(cs, rays, active, 1024, False)
    bb = dense.cluster_boxes(cs)
    default = dict(precision="default", G3b=cs.G3b)
    plain = dict(precision="default", group=dense.BF16_WARP_RAYS, boxes=bb)
    got = dense.dense_closest_hit(*a1, boxes=bb, **default)
    want = dense.dense_closest_hit_plain(*a1, **plain)
    hit = want[1] >= 0
    assert hit.any() and ((got[1] >= 0) == hit).float().mean() >= 0.9995
    both = hit & (got[1] >= 0)
    assert (got[1] == want[1])[both].float().mean() >= 0.9995

    attr, tri, t, u, v = dense.reconstruct(cs, rays,
                                           torch.where(hit, want[1], 0))
    surf = surface_from_attrs(attr, cs.mat_params, rays,
                              dense.make_hits(rays, hit, tri, t, u, v))
    a4 = _dense_case(cs, shadow_rays(surf), active & hit, 1024, False)
    occ = dense.dense_occluded(*a4, boxes=bb, **default)
    occ_p = dense.dense_occluded_plain(*a4, **plain)
    assert occ_p.any() and not occ_p.all()
    assert (occ == occ_p).float().mean() >= 0.9995

    Fp, items, short = _pair_case(cs, 4096, 11, cuda)
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    for guard in (False, True):
        want = sparse.pair_hit_plain(Fp, cs.G3, items, col_bits, guard,
                                     precision="default")
        for it in (items, short):
            _same_words(sparse.pair_hit(Fp, cs.G3, it, col_bits, guard,
                                        **default),
                        want, (1 << (col_bits + 3)) - 1)
    after = [(fn.launches, fn.launches_bf16) for fn in counted]
    assert [(a - b, c - d) for (a, c), (b, d) in zip(after, before)] == \
        [(1, 1), (1, 1), (4, 4)]


def _edge_case(cs, rays, active, tile):
    """The dense inputs at ``tile`` with the walk's edges: the second warp
    of the bf16 variants (``BF16_WARP_RAYS`` rays) inactive, tile 1's
    queue row empty and tile 2's at ``tile_cap`` (its tail the farthest
    cluster repeated)."""
    w = dense.BF16_WARP_RAYS
    active = active.clone()
    active[w:2 * w] = False
    a = list(_dense_case(cs, rays, active, tile, False))
    a[4] = a[4].clone()
    a[4][1] = 0
    a[4][2] = dense.DEFAULT_TILE_CAP
    return active, tuple(a)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("cluster_size", [16, 100, 128])
def test_bf16_dense_kernels_match_plain_at_the_walks_edges(
        cuda, scene_data, cluster_size, tile):
    """The tensor-core variants of K1 and K4 against their plain versions
    at "default", walking in the kernels' group (``BF16_WARP_RAYS``), at
    shapes the headline never reaches: clusters of 16, 100 (a last group of
    4 triangles cut short) and 128; the smallest tile a CTA takes and twice
    that; a whole inactive warp; an empty queue row and one at tile_cap;
    rays with tmin > 0. Hits at the oracle bar (hit agreement and
    t within 1e-3 relative on >= 99.95%), K4's flags on >= 99.95% of rays;
    an inactive ray or one with an empty row never hits; the pairs walked
    are whole warps. At "highest" the fp32 forms launch."""
    cs = cluster_scene_from_numpy(
        **compile_clusters_np(scene_data, cluster_size=cluster_size),
        device=cuda)
    rays, active = _primaries(scene_data, 64, cuda)
    tmin = torch.where(torch.arange(64 * 64, device=cuda) % 3 == 0,
                       torch.rand(64 * 64, generator=torch.Generator(
                           device=cuda).manual_seed(3), device=cuda) * 30,
                       rays.tmin)
    rays = rays._replace(tmin=tmin)
    active, a1 = _edge_case(cs, rays, active, tile)
    empty = torch.zeros_like(active)
    empty[tile:2 * tile] = True
    bb = dense.cluster_boxes(cs)
    default = dict(precision="default", G3b=cs.G3b, boxes=bb)
    plain = dict(precision="default", group=dense.BF16_WARP_RAYS, boxes=bb)
    with pytest.raises(ValueError, match="G3b"):
        dense.dense_closest_hit(*a1, boxes=bb, precision="default")

    walked = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = dense.dense_closest_hit(*a1, walked=walked, **default)
    want = dense.dense_closest_hit_plain(*a1, **plain)
    hit, hit_k = want[1] >= 0, got[1] >= 0
    assert hit.any() and ((tmin > 0) & active & hit).any()
    assert (hit_k == hit).float().mean() >= 0.9995
    low = (1 << 7) - 1
    both = hit & hit_k
    t_k, t_p = ((w[0] & ~low).view(torch.float32)[both] for w in (got, want))
    assert (((t_k - t_p).abs() / t_p.clamp_min(1e-6)) < 1e-3).float().mean() \
        >= 0.9995
    assert not hit_k[~active | empty].any()
    assert int(walked[0]) > 0 and int(walked[0]) % dense.BF16_WARP_RAYS == 0

    attr, tri, t, u, v = dense.reconstruct(cs, rays,
                                           torch.where(hit, want[1], 0))
    surf = surface_from_attrs(attr, cs.mat_params, rays,
                              dense.make_hits(rays, hit, tri, t, u, v))
    s_active, a4 = _edge_case(cs, shadow_rays(surf), active & hit, tile)
    occ = dense.dense_occluded(*a4, **default)
    occ_p = dense.dense_occluded_plain(*a4, **plain)
    assert occ_p.any() and not occ_p.all()
    assert (occ == occ_p).float().mean() >= 0.9995
    assert not occ[~s_active | empty].any()

    launches = [(fn.launches, fn.launches_bf16)
                for fn in (dense.dense_closest_hit, dense.dense_occluded)]
    fp32 = dense.dense_closest_hit(*a1, boxes=bb)
    fp32_p = dense.dense_closest_hit_plain(*a1, boxes=bb)
    assert ((fp32[1] >= 0) == (fp32_p[1] >= 0)).float().mean() >= 0.9995
    dense.dense_occluded(*a4, boxes=bb)
    assert [(fn.launches, fn.launches_bf16)
            for fn in (dense.dense_closest_hit, dense.dense_occluded)] == \
        [(n + 1, b) for n, b in launches]


# ---- the walk's gate: each CTA keeps the queued clusters its rays enter ----

def _exact_walk(cs, rays, active, tile, tile_cap, seed):
    """The dense inputs at ``tile`` on rays whose origins are multiples of
    1/8 and directions multiples of 1/64, with G3 of integer features
    (``_integer_operands``) and its bf16 fragment copy: every product of
    the dense kernels, fp32 or bf16, and every sum of ten is exact, so the
    kernels and their plain versions give the same words in any order of
    summation. The queue is the cull kernel's, over the scene's boxes."""
    rays = make_rays(torch.round(rays.o * 8) / 8,
                     torch.round(rays.d * 64) / 64, rays.tmin, rays.tmax)
    F, q_cl, q_en, q_n, _ = dense._dense_inputs(
        cs, rays, active, tile, dense.K_PER_STEP, tile_cap)
    _, G3i = _integer_operands(F[:1], cs.G3, seed)
    return (F, G3i, q_cl, q_en, q_n, tile), mma_fragments(G3i)


def _gated_walks_match_plain(cs, a, G3b):
    """K1, K4 and their bf16 variants against their plain versions on the
    inputs ``a``: the words bit for bit, and ``walked`` (the pairs the
    warps tested, the clusters the CTAs staged) as the plain walk counts
    them, both below the tile walk's rays x queue length and CTAs x queue
    length. Returns {(kernel, precision): walked}."""
    F, _, _, _, q_n, tile = a
    rows = int(q_n.sum())
    counts = {}
    for kernel, plain in ((dense.dense_closest_hit,
                           dense.dense_closest_hit_plain),
                          (dense.dense_occluded, dense.dense_occluded_plain)):
        for precision in ("highest", "default"):
            kw = dict(boxes=dense.cluster_boxes(cs), precision=precision)
            w_k = torch.zeros(2, dtype=torch.int64, device=F.device)
            w_p = torch.zeros(2, dtype=torch.int64, device=F.device)
            got = kernel(*a, walked=w_k, G3b=G3b, **kw)
            want = plain(*a, walked=w_p, **kw)
            name = (kernel.__name__, precision)
            assert torch.equal(got, want), name
            assert w_k.tolist() == w_p.tolist(), (name, w_k, w_p)
            pairs, staged = w_k.tolist()
            assert 0 < pairs < tile * rows, name
            assert 0 < staged < tile // dense.CTA_RAYS * rows, name
            counts[name] = (pairs, staged)
    return counts


def _two_groups():
    """Two groups of 128 small triangles, 8 units apart (an 8 x 8 grid of
    quads in the plane z = 0 around x = -4 and x = +4)."""
    verts, tris = [], []
    for cx in (-4.0, 4.0):
        g = np.linspace(-1.0, 1.0, 9)
        base = len(verts)
        verts += [(cx + x, y, 0.0) for y in g for x in g]
        for i in range(8):
            for j in range(8):
                k = base + 9 * i + j
                tris += [(k, k + 1, k + 10), (k, k + 10, k + 9)]
    v = np.asarray(verts, np.float32)
    idx = np.asarray(tris, np.uint32)
    n = np.tile(np.asarray([[0, 0, 1]], np.float32), (len(idx), 1))
    return SceneData(vertices=v, indices=idx,
                     triangle_materials=np.zeros(len(idx), np.uint16),
                     triangle_normals=n,
                     normals=np.tile(n[:1], (len(v), 1)),
                     texcoords=np.zeros((len(v), 2), np.float32),
                     materials=np.asarray([[0.8, 0.8, 0.8, 1.5]],
                                          np.float32))


def test_gated_walk_is_the_plain_walk_on_two_groups_of_clusters(cuda):
    """Tiles whose queue holds both groups of ``_two_groups``, and CTAs
    whose rays aim at one group (``A`` or ``B``), at the sky, or warp by
    warp at A, B and the sky; one lane in seven inactive, a whole warp and
    a whole CTA inactive. K1, K4 and their bf16 variants give their plain
    versions' words bit for bit and count what the plain walk counts: the
    CTAs and warps skip the group their rays never enter."""
    cs = cluster_scene_from_numpy(
        **compile_clusters_np(_two_groups(), cluster_size=16), device=cuda)
    tile, T = 1024, 4
    # Lane i of the kernels' CTA order (dense.cta_order) is row order[i].
    order = dense.cta_order(T * tile, tile).numpy()
    lane = np.empty(T * tile, np.int64)
    lane[order] = np.arange(T * tile)
    cta = lane % tile // dense.CTA_RAYS
    warp = lane % dense.CTA_RAYS // dense.WARP_RAYS
    kind = np.where(cta % 4 == 3, warp % 3, cta % 4)    # 0 A, 1 B, 2 sky
    rs = np.random.default_rng(21)
    target = np.stack([np.where(kind == 0, -4.0, 4.0)
                       + rs.uniform(-1.2, 1.2, lane.size),
                       rs.uniform(-1.2, 1.2, lane.size),
                       np.zeros(lane.size)], axis=1)
    o = np.tile(np.asarray([[0.0, 0.0, -8.0]]), (lane.size, 1))
    d = np.where((kind == 2)[:, None], [[0.3, 0.2, -1.0]], target - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rs.random(lane.size) >= 1 / 7
    active[(cta == 5) & (warp == 2) & (lane < tile)] = False
    active[(cta == 0) & (lane // tile == 3)] = False
    rays = make_rays(torch.tensor(o, dtype=torch.float32, device=cuda),
                     torch.tensor(d, dtype=torch.float32, device=cuda),
                     tmin=0.0, tmax=1e6)
    a, G3b = _exact_walk(cs, rays, torch.tensor(active, device=cuda), tile,
                         dense.DEFAULT_TILE_CAP, 5)
    x = cs.cl_bbmin[a[2].long(), 0]
    assert ((x < 0).any(dim=1) & (x > 0).any(dim=1)).all()  # both groups
    counts = _gated_walks_match_plain(cs, a, G3b)
    # At most half the CTAs' rays aim at a group, so at most ~3/4 of the
    # tile walk's staging is left.
    assert counts[("dense_closest_hit", "highest")][1] < \
        0.75 * tile // dense.CTA_RAYS * int(a[4].sum())


@pytest.mark.parametrize("tile,tile_cap", [(1024, 256), (4096, 512),
                                           (16384, 512)])
def test_gated_walk_is_the_plain_walk_on_tetra(cuda, tile, tile_cap):
    """SPD tetra at size factor 5 (4,096 triangles in 512 clusters of 8)
    seen through its holes by its camera, 128 x 128 primaries in tiles of
    ``tile``, the queue from ``cull_and_queue``; at tile_cap 512 some rows
    (at 16,384 the one row, all 512 clusters) take two windows of the
    gate. K1, K4 and their bf16 variants give their plain versions' words
    bit for bit and count what the plain walk counts; K1 tests under a
    third of the tile walk's pairs."""
    from rtbench.scenes import spd_tetra
    sd = SceneData(**spd_tetra.generate(0, max_depth=2, size_factor=5,
                                        viewport=(128, 128)))
    cs = cluster_scene_from_numpy(**compile_clusters_np(sd, cluster_size=8),
                                  device=cuda)
    rays, active = _primaries(sd, 128, cuda)
    a, G3b = _exact_walk(cs, rays, active, tile, tile_cap, 9)
    rows = int(a[4].sum())
    if tile_cap == 512:
        assert int(a[4].max()) > dense.GATE_ROWS
    counts = _gated_walks_match_plain(cs, a, G3b)
    assert counts[("dense_closest_hit", "highest")][0] < tile * rows / 3


def _unit_edge_items(Fp, n_c, sizes):
    """Items tiling the pairs [0, P) in runs of ``sizes`` (in turn), each
    naming the cluster of its first pair, so that a run also holds pairs
    of other clusters; the last ends at P, and one in the middle names
    cluster n_c + 5 (no cluster of the scene)."""
    lanes = Fp[:, 12].contiguous().view(torch.int32).cpu()
    P = Fp.shape[0]
    cuts, s, j = [], 0, 0
    while s < P:
        e = min(s + sizes[j % len(sizes)], P)
        cuts.append([s, e, int(lanes[s]) & sparse._CL_MASK])
        s, j = e, j + 1
    cuts[len(cuts) // 2][2] = n_c + 5
    return torch.tensor(cuts, dtype=torch.int32, device=Fp.device)


def _integer_operands(Fp, G3, seed):
    """Fp and G3 with integer features in [-16, 16] and a half-odd
    constant (feature 9 of G3; Fp's is 1), so that every bf16 operand,
    product and sum is exact and no sum is zero: the tensor cores and the
    plain version compute the same bits in any order. G3's zero rows (the
    padding of a short cluster) stay zero; Fp keeps its tmin, tmax and
    lane word."""
    rs = np.random.default_rng(seed)
    live = (G3[:, :, :10] != 0).any(dim=2, keepdim=True)
    g = rs.integers(-16, 17, G3.shape).astype(np.float32)
    g[:, :, 9] = rs.integers(-16, 16, G3.shape[:2]) + 0.5
    g[:, :, 10:] = 0
    G3i = torch.where(live, torch.tensor(g, device=G3.device), 0.0)
    f = rs.integers(-16, 17, (Fp.shape[0], 9)).astype(np.float32)
    Fpi = Fp.clone()
    Fpi[:, :9] = torch.tensor(f, device=Fp.device)
    Fpi[:, 9] = 1.0
    return Fpi, G3i.contiguous()


def _exact_scores(Fp, G3, q, col):
    """The score t = ts * (1 / |det|) of pair q against column ``col`` of
    its lane word's cluster, on bf16-rounded features, as
    ``pair_hit_plain`` computes it at "default"."""
    C = G3.shape[1] // 4
    cl = Fp[q, 12].contiguous().view(torch.int32).long() & sparse._CL_MASK
    rows = col.long()[:, None] + C * torch.arange(4, device=Fp.device)
    g = dense.round_bf16(G3[cl[:, None], rows, :10])          # (n, 4, 10)
    f = dense.round_bf16(Fp[q, :10])
    S = f[:, 0:1] * g[:, :, 0]
    for i in range(1, 10):
        S = S + f[:, i:i + 1] * g[:, :, i]
    det_i = S[:, 0].contiguous().view(torch.int32)
    ts = (S[:, 3].contiguous().view(torch.int32) ^ (det_i & -0x80000000)
          ).view(torch.float32)
    return ts * torch.reciprocal(S[:, 0].abs())


@pytest.mark.parametrize("guard_tmax", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("cluster_size", [6, 16, 100, 128])
def test_bf16_pair_kernel_matches_plain_at_the_units_edges(
        cuda, scene_data, cluster_size, guard_tmax):
    """K3's tensor-core variant against its plain version at "default",
    at the edges of its work units: items of 1, 15, 16, 17, 63, 64, 65 and
    200 pairs (a warp of 16 pairs partly or wholly past its unit), the last
    unit ending at P, runs holding pairs whose lane word names another
    cluster (never written), an item naming no cluster of the scene (no
    unit), and pairs whose tmin is a hit's exact score (the restart
    window's edge); clusters of 6 and 100 end inside a group of 4
    triangles. On integer operands (``_integer_operands``) the words are
    equal bit for bit, at the tmin edge too; uncovered pairs keep the miss
    marker, and the work units are those of the fp32 form. Without the
    scene's fragment copy the wrapper raises."""
    cs = cluster_scene_from_numpy(
        **compile_clusters_np(scene_data, cluster_size=cluster_size),
        device=cuda)
    Fp, _, _ = _pair_case(cs, 4096, 13, cuda)
    Fp, G3 = _integer_operands(Fp, cs.G3, cluster_size)
    G3b = mma_fragments(G3)
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    sizes = [1, 15, 16, 17, 63, 64, 65, 200]
    items = _unit_edge_items(Fp, cs.n_clusters, sizes)
    runs = (items[:, 1] - items[:, 0]).tolist()
    assert set(sizes) <= set(runs) and int(items[-1, 1]) == Fp.shape[0]

    # A third of the pairs that hit get their winner's exact score as tmin.
    first = sparse.pair_hit_plain(Fp, G3, items, col_bits, guard_tmax,
                                  precision="default")
    q = (first < sparse._MISS_BITS).nonzero().squeeze(1)[::3]
    assert q.numel() > 0
    Fp[q, 10] = _exact_scores(Fp, G3, q, first[q] & ((1 << col_bits) - 1))
    assert (Fp[q, 10] > 0).all()

    with pytest.raises(ValueError, match="G3b"):
        sparse.pair_hit(Fp, G3, items, col_bits, guard_tmax,
                        precision="default")
    want = sparse.pair_hit_plain(Fp, G3, items, col_bits, guard_tmax,
                                 precision="default")
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = sparse.pair_hit(Fp, G3, items, col_bits, guard_tmax, stats=stats,
                          precision="default", G3b=G3b)
    assert torch.equal(got, want)
    hit = want[q] < sparse._MISS_BITS
    assert hit.any() and not hit.all()      # the edge goes both ways
    pos = torch.arange(Fp.shape[0], device=cuda)
    item = torch.searchsorted(items[:, 0].contiguous(), pos.int(),
                              right=True) - 1
    lane_cl = Fp[:, 12].contiguous().view(torch.int32) & sparse._CL_MASK
    covered = lane_cl == items[item, 2]
    assert (~covered).any() and (got[covered] < sparse._MISS_BITS).any()
    assert (got[~covered] == sparse._MISS_BITS).all()
    fp32 = torch.zeros(3, dtype=torch.int64, device=cuda)
    sparse.pair_hit(Fp, G3, items, col_bits, guard_tmax, stats=fp32)
    real = items[:, 2] < cs.n_clusters
    units = int(((items[:, 1] - items[:, 0] + 63) // 64)[real].sum())
    assert int(stats[0]) == units == int(fp32[0])


def test_scene_built_on_the_host_renders_on_the_card(cuda, scenes,
                                                    scene_data):
    """A cluster scene and an environment made with device="cpu" and handed
    to a renderer on the card are traced there: the frame launches K1, K2
    and K3, and a host environment re-published through ``render`` is
    sampled on the card too."""
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.environment import create_environment
    sd = type(scene_data)(**{**scene_data.__dict__, "viewport_width": 64,
                             "viewport_height": 64, "max_depth": 2})
    px = sd.env_pixels
    env = create_environment(px, px.shape[1], px.shape[0], device="cpu")
    ctx = racc.create_context(racc.Configuration(wave_size=4096,
                                                 trace_block=512),
                              device=cuda)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 64, 64)
    r = racc.PathTracingRenderer(ctx, cam, sd, tpu_scene=scenes[0],
                                 environment=env)
    assert r.scene.G3.device.type == r.environment.quad.device.type == "cuda"
    before = _launch_counts()
    r.render_frame(rng.PRNGKey(0))
    env2 = create_environment(px * 0.5, px.shape[1], px.shape[0],
                              device="cpu")
    racc.render(ctx, scenes[0], env2, r)
    assert r.environment.quad.device.type == "cuda"
    assert all(a > b for a, b in zip(_launch_counts(), before))
    img = r.image()
    assert r.dropped == 0 and np.isfinite(img).all() and img.max() > 0


def test_oracle_on_the_card_passes_the_bar(cuda):
    """``tools/oracle_lib.py``'s ray sets on the test scene on the card:
    every cluster engine against ``mxu`` above the oracle bar, the sky set
    (no candidate pair: K3 skipped, K2 with every lane culled) included,
    and K1-K4 launched. The reference takes its primaries from the middle
    of a 1280x720 frame, so the scene is rendered at that size."""
    from rayaccel_tpu_torch.scene.clusters import compile_clusters
    from rayaccel_tpu_torch.scene.loader import make_test_scene
    from rayaccel_tpu_torch.tools.oracle_lib import oracle_bar, run_oracle

    sd = make_test_scene(viewport=(1280, 720))
    cs = compile_clusters(sd, cluster_size=32, device=cuda)
    before = {fn: fn.launches for fn in (
        dense.dense_closest_hit, dense.dense_occluded, sparse.select_nearest,
        sparse.pair_hit)}
    rows, ok = run_oracle(cs, sd, n_rays=8192)
    assert ok and oracle_bar(rows)
    assert [r["rays"] for r in rows].count("sky") == 4
    assert all(fn.launches > n for fn, n in before.items())


# ---- the probes: P1-P3 (tools/probe_dma.py), P4 (tools/probe_pair_dma.py)

_LIST64 = [(5 * j + 3) % 8 for j in range(64)]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", [
    ("static", 0), ("static", 8), ("static", 56),
    ("dynamic", [0]), ("dynamic", [3]), ("dynamic", [7]),
    ("worklist", [1, 5, 2, 7]), ("worklist", [0]),
    ("worklist", [7, 7, 0, 3, 3, 1]), ("worklist", list(range(8)) * 4),
    ("worklist", _LIST64), ("worklist", _LIST64, {"stages": 3}),
    ("worklist", [1, 5, 2, 7], {"stages": 1}),
    ("worklist", [1, 6, 2, 7, 0, 3, 5, 4, 1, 1], {"block": (4, 3072)}),
    ("worklist", [1, 0, 7, 1], {"block": (4, 6400)}),
    ("worklist", [0, 0, 0], {"negative_zero": 0})],
    ids=str)
def test_dma_probes_match_plain_bitwise(cuda, case):
    """P1-P3 on the probe's x and on a (96, 36) array in blocks of 4 rows
    (576 bytes) against their plain versions, bit for bit. P3 keeps a
    stage a block in flight, so a wrong parity or a stage refilled before
    it is read shows as a stale block or a timeout: a list of 64 (the
    probe's block: 56 stages, the ring wraps; at ``stages`` 3 it wraps
    21 times), one stage, blocks of 48 KB (4 rows of 3072: 4 stages fit)
    and of 100 KB (4 rows of 6400: two slices of 64 KB and 36 KB a block,
    3 stages), and a first block of -0.0, whose sum from zeros is +0.0."""
    from rayaccel_tpu_torch.tools import probe_dma as pd
    kind, arg, *opt = case
    opt = opt[0] if opt else {}
    other = torch.tensor(np.random.default_rng(7).normal(size=(96, 36)),
                         dtype=torch.float32, device=cuda)
    arrays = [(pd.probe_input(cuda), 8), (other, 4)]
    if "block" in opt:
        rows, W = opt["block"]
        arrays = [(torch.tensor(np.random.default_rng(8).normal(
            size=(8 * rows, W)), dtype=torch.float32, device=cuda), rows)]
    if "negative_zero" in opt:
        for x, rows in arrays:
            x[opt["negative_zero"] * rows:][:rows] = -0.0
    room = pd.smem_optin(cuda)
    for x, rows in arrays:
        fn = getattr(pd, f"copy_{kind}")
        plain = getattr(pd, f"copy_{kind}_plain")
        args = ((x, arg * rows // 8, rows) if kind == "static" else
                (x, torch.tensor(arg, dtype=torch.int32, device=cuda), rows))
        kw = {}
        if kind == "worklist":
            block = rows * x.shape[1] * 4
            kw["smem"] = opt.get("stages", 0) * (block + 16)
            plan = pd.worklist_plan(len(arg), block, kw["smem"] or room)
            assert 0 < plan["stages"] <= len(arg)
            if "stages" in opt:
                assert plan["stages"] == opt["stages"]
        launches = fn.launches
        got = fn(*args, **kw)
        assert fn.launches == launches + 1
        assert torch.equal(_bits(got), _bits(plain(*args)))
        assert torch.equal(_bits(got).cpu(), _bits(plain(
            *(a.cpu() if torch.is_tensor(a) else a for a in args))))
        if "negative_zero" in opt:
            assert not torch.signbit(got).any()


def test_dma_probes_raise_instead_of_copying_wrong(cuda):
    """A bulk copy whose size is not a multiple of 16 bytes or whose start
    is not 16-byte aligned is refused before the launch; an index read on
    the device out of range, too little shared memory and a launch the
    card refuses (more shared memory than a CTA may have) each raise, and
    no output is returned. P3 checks its whole list before any copy: a bad
    last index of 64 raises naming that index."""
    from rayaccel_tpu_torch.tools import probe_dma as pd
    narrow = torch.zeros((64, 3), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        pd.copy_static(narrow, 0, 1)                      # 12 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        pd.copy_static(narrow, 1, 4)                      # starts at byte 12
    with pytest.raises(ValueError, match="multiple of 16"):
        pd.copy_worklist(narrow, torch.tensor([0], dtype=torch.int32,
                                              device=cuda), 1)
    x = pd.probe_input(cuda)
    bad = torch.tensor([1, 8], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="out of range"):
        pd.copy_worklist(x, bad)
    with pytest.raises(RuntimeError, match="out of range"):
        pd.copy_dynamic(x, bad[1:])
    with pytest.raises(RuntimeError, match="less dynamic shared memory"):
        pd.copy_static(x, smem=2048)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pd.copy_static(x, smem=400_000)
    # P3: a bad index last, at once and in a ring of 3 stages; a stage
    # larger than its shared memory; more than a CTA may have.
    last = torch.tensor(_LIST64[:-1] + [-1], dtype=torch.int32, device=cuda)
    for smem in (0, 3 * 4112):
        with pytest.raises(RuntimeError, match=r"out of range \(step 63\)"):
            pd.copy_worklist(x, last, smem=smem)
    assert pd.worklist_plan(4, 4096, 4111)["stages"] == 0
    with pytest.raises(RuntimeError, match="less dynamic shared memory"):
        pd.copy_worklist(x, bad[:1], smem=4111)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pd.copy_worklist(x, bad[:1], smem=400_000)
    # The card is still usable, and a good launch still right.
    assert torch.equal(pd.copy_static(x), x[8:16])
    assert torch.equal(pd.copy_worklist(x, bad[:1]), x[8:16])


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("cluster_size", [6, 16, 64, 128])
def test_pair_hit_mb_equals_k3(cuda, scene_data, cluster_size, stages):
    """P4 against K3 on the same pairs (runs longer than a 64-pair unit,
    a cluster on both sides of an SP boundary, and the same pairs cut into
    items of 1-5), closest and any hit, at each ring depth: every word
    equal, the uncovered pairs the miss marker; at the oracle bar against
    the plain version; every unit tested, by no more CTAs than the grid,
    and 48 bytes staged a G3 row."""
    from rayaccel_tpu_torch.tools import probe_pair_dma as pm
    cs = cluster_scene_from_numpy(
        **compile_clusters_np(scene_data, cluster_size=cluster_size),
        device=cuda)
    Fp, items, short = _pair_case(cs, 4096, 11, cuda)
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    for guard in (False, True):
        for it in (items, short):
            stats = torch.zeros(3, dtype=torch.int64, device=cuda)
            got = pm.pair_hit_mb(Fp, cs.G3, it, col_bits, guard,
                                 stages=stages, stats=stats)
            assert torch.equal(got, sparse.pair_hit(Fp, cs.G3, it, col_bits,
                                                    guard))
            units, ctas, staged = stats.tolist()
            runs = (it[:, 1] - it[:, 0]).long()
            assert units == int(((runs + 63) // 64).sum())
            assert 0 < ctas <= pm.launch_grid(Fp.shape[0], it.shape[0],
                                              stages, guard)
            assert staged % (4 * cluster_size * 48) == 0 and staged > 0
        _same_words(got, pm.pair_hit_mb_plain(Fp, cs.G3, short, col_bits,
                                              guard, sp=512),
                    (1 << (col_bits + 3)) - 1)


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_pair_hit_mb_counters_equal_the_plan(cuda, scene_data, stages):
    """P4's counters (units tested, CTAs that took any, bytes staged) equal
    the host's plan of its grid, computed from the items alone, on a
    pass's runs and on the same runs cut into items of 1-5, with clusters
    of 128; where the grid is K3's, the bytes are K3's clusters staged
    times 48 bytes a row."""
    from rayaccel_tpu_torch.tools import probe_pair_dma as pm
    cs = cluster_scene_from_numpy(**compile_clusters_np(scene_data),
                                  device=cuda)
    C = cs.cluster_size
    col_bits = max((C - 1).bit_length(), 1)
    for R in (1024, 65536):
        Fp, items, short = _pair_case(cs, R, R + stages, cuda)
        P = Fp.shape[0]
        for it in (items, short):
            stats = torch.zeros(3, dtype=torch.int64, device=cuda)
            pm.pair_hit_mb(Fp, cs.G3, it, col_bits, False, stages=stages,
                           stats=stats)
            grid = pm.launch_grid(P, it.shape[0], stages)
            want = pm.plan(it, P, cs.n_clusters, C, grid)
            assert stats.tolist() == [want["units"], want["ctas"],
                                      want["bytes_staged"]]
            k3 = torch.zeros(3, dtype=torch.int64, device=cuda)
            sparse.pair_hit(Fp, cs.G3, it, col_bits, False, stats=k3)
            units, ctas, clusters = k3.tolist()
            assert units == want["units"]
            if ctas == want["ctas"]:
                assert want["bytes_staged"] == clusters * pm.stage_bytes(C)


def test_pair_hit_mb_raises_instead_of_returning_stale_words(cuda, scenes):
    """P4 launched with less shared memory than its ring raises (the kernel
    checks what it was given), as does a launch the card refuses, a ring
    depth outside 2-4, and a G3 that does not start on 16 bytes, whose
    tensor map the host refuses to encode, naming the argument; none falls
    back to K3 or to the plain version."""
    from rayaccel_tpu_torch.tools import probe_pair_dma as pm
    _, cs = scenes
    Fp, items, _ = _pair_case(cs, 1024, 3, cuda)
    col_bits = max((cs.cluster_size - 1).bit_length(), 1)
    args = (Fp, cs.G3, items, col_bits, False)
    launches = pm.pair_hit_mb.launches
    with pytest.raises(RuntimeError, match="less dynamic shared memory"):
        pm.pair_hit_mb(*args, smem=4096)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pm.pair_hit_mb(*args, smem=400_000)
    with pytest.raises(ValueError, match="stages"):
        pm.pair_hit_mb(*args, stages=1)
    flat = torch.zeros(cs.G3.numel() + 1, device=cuda)
    shifted = flat[1:].view(cs.G3.shape)
    with pytest.raises(ValueError, match="globalAddress.*16 bytes"):
        pm.pair_hit_mb(Fp, shifted, items, col_bits, False)
    assert pm.pair_hit_mb.launches == launches + 1
    assert torch.equal(pm.pair_hit_mb(*args), sparse.pair_hit(*args))


# ---- the threefry draws (csrc/threefry.cu) against the plain int64 path,
# over the keys, lane ids and pixels of tests/rng_cases.py


def _same_words(got, want):
    assert got.shape == want.shape and got.device.type == "cuda"
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("spec", KEYS)
@pytest.mark.parametrize("shape", [(2, 65536), (65536, 3), (983040, 3),
                                   (5,), (0,)])
def test_threefry_positional_draws_are_the_plain_words(cuda, shape, spec):
    """``uniform`` at the camera jitter's (2, R) and the first BSDF draw's
    (R, 3), at a wave's width and the bounce pool's, a short and an empty
    stream: one launch, the plain path's words."""
    launches = rng.threefry_draws.launches
    got = rng.uniform(key(spec), shape, device=cuda)
    _same_words(got, rng.uniform_plain(key(spec), shape, cuda))
    assert tuple(got.shape) == shape
    assert rng.threefry_draws.launches == launches + (got.numel() > 0)


@pytest.mark.parametrize("count", [1, 255, 257, 65553, 983029])
@pytest.mark.parametrize("spec", KEYS)
def test_threefry_lane_draws_are_the_plain_words(cuda, spec, count):
    """``lane_uniform`` on the edge lane ids and a run of ``count`` more
    (12 to 983,040 lanes, mostly not a multiple of the 256-thread block),
    int32 as the pools hold them."""
    lanes = torch.cat([torch.tensor(EDGE_LANES), torch.arange(count)]).to(
        dtype=torch.int32, device=cuda)
    launches = rng.threefry_draws.launches
    got = rng.lane_uniform(key(spec), lanes)
    _same_words(got, rng.lane_uniform_plain(key(spec), lanes))
    assert rng.threefry_draws.launches == launches + 1


def test_threefry_takes_int32_ids_only(cuda):
    """The kernel reads int32 lane ids and pixels; an int64 tensor is
    refused before any launch."""
    launches = rng.threefry_draws.launches
    wide = torch.arange(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="ids must be torch.int32"):
        rng.lane_uniform(key(KEYS[0]), wide)
    with pytest.raises(ValueError, match="ids must be torch.int32"):
        rng.fold_in_uniform_pair(key(KEYS[0]), wide)
    assert rng.threefry_draws.launches == launches


@pytest.mark.parametrize("spec", KEYS)
def test_threefry_pair_draws_are_the_plain_words(cuda, spec):
    """The stratified sampler's per-pixel pair at the frame's corners and
    middle, alone and together, and over a whole 1280x720 image."""
    for pixels in ([EDGE_PIXELS[0]], [EDGE_PIXELS[1]], EDGE_PIXELS):
        pix = torch.tensor(pixel_ids(*zip(*pixels)), dtype=torch.int32,
                           device=cuda)
        _same_words(rng.fold_in_uniform_pair(key(spec), pix),
                    rng.fold_in_uniform_pair_plain(key(spec), pix))
    ys, xs = torch.meshgrid(
        torch.arange(720, dtype=torch.int32, device=cuda),
        torch.arange(1280, dtype=torch.int32, device=cuda), indexing="ij")
    pix = (ys << 16) | xs
    got = rng.fold_in_uniform_pair(key(spec), pix)
    assert tuple(got.shape) == (720, 1280, 2)
    _same_words(got, rng.fold_in_uniform_pair_plain(key(spec), pix))


def _force_plain_draws(monkeypatch):
    """Every draw through its plain int64 path, on the card too."""
    monkeypatch.setattr(rng, "uniform", lambda k, shape, device=None:
                        rng.uniform_plain(k, shape, resolve_device(device)))
    monkeypatch.setattr(rng, "lane_uniform", rng.lane_uniform_plain)
    monkeypatch.setattr(rng, "fold_in_uniform_pair",
                        rng.fold_in_uniform_pair_plain)


@pytest.mark.parametrize("kind", ["pt", "pt_stratified", "whitted"])
def test_frames_on_the_kernel_draws_equal_the_plain_draws(
        cuda, scenes, scene_data, monkeypatch, kind):
    """Two pooled frames (the path tracer with the uniform and the
    stratified sampler; Whitted trees to depth 3) on the kernel's draws and
    again on the plain draws: the same radiance bit for bit, the same rays
    traced, nothing dropped."""
    import rayaccel_tpu_torch as racc
    pt = kind != "whitted"
    sd = type(scene_data)(**{**scene_data.__dict__, "viewport_width": 320,
                             "viewport_height": 180,
                             "max_depth": 2 if pt else 3})
    cfg = racc.Configuration(
        wave_size=16384, trace_block=1024,
        sampler="stratified" if kind == "pt_stratified" else "uniform")
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 320, 180)
    cls = racc.PathTracingRenderer if pt else racc.WhittedRenderer

    def frames():
        r = cls(racc.create_context(cfg, device=cuda), cam, sd,
                tpu_scene=scenes[1])
        assert r.pooled
        launches = rng.threefry_draws.launches
        traced = [int(r.render_frame(rng.PRNGKey(k)).rays_traced)
                  for k in (3, 4)]
        return (r.image(), traced, r.dropped,
                rng.threefry_draws.launches - launches)

    img, traced, dropped, launches = frames()
    _force_plain_draws(monkeypatch)
    img_p, traced_p, dropped_p, launches_p = frames()
    assert launches > 0 and launches_p == 0
    np.testing.assert_array_equal(img.view(np.uint32), img_p.view(np.uint32))
    assert traced == traced_p and dropped == dropped_p == 0
    assert np.isfinite(img).all() and img.max() > 0
