"""The ports of the TPU probes that reach ``pl.pallas_call``:
``rayaccel_tpu_torch/tools/probe_dma.py`` (P1-P3, the manual-DMA probes of
``tools/probe_dma.py``) and ``rayaccel_tpu_torch/tools/probe_pair_dma.py``
(P4, the multi-block pair kernel of ``tools/probe_pair_dma.py``), on the
CPU through their plain versions.

The repo-root probes run their steps when imported and need a TPU, so
P1-P3 are held to the expectations the probe asserts, and P4's block walk
to a numpy rendering of the probe's own run offsets. P4's plain version
is held bit for bit against K3's, and against the JAX pair kernel in
interpret mode at HIGHEST on the same items."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayaccel_tpu.ops.trace_sparse import _make_call as pair_call
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene

from rayaccel_tpu_torch.ops import trace_dense as dense
from rayaccel_tpu_torch.ops import trace_sparse as sparse
from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
from rayaccel_tpu_torch.scene.clusters import (cluster_scene_from_numpy,
                                               compile_clusters_np)
from rayaccel_tpu_torch.scene.loader import make_battlefield_like
from rayaccel_tpu_torch.tools import probe_dma as pd
from rayaccel_tpu_torch.tools import probe_pair_dma as pm
from rayaccel_tpu_torch.types import Rays

from tests.torch_helpers import (assert_agrees_with_jax, camera_rays,
                                 port_rays, port_scene, random_rays)

torch.set_num_threads(2)

SP = 256
HIGHEST = jax.lax.Precision.HIGHEST


# ---- P1-P3 ----

@pytest.mark.parametrize("step", ["A", "B", "C"])
def test_dma_plain_versions_equal_the_probes_expectations(step):
    """Each step's plain version (and its wrapper, which takes it on a CPU
    tensor) equals what the probe asserts, bit for bit: x[8:16]
    (tools/probe_dma.py:53), x[24:32] (:84) and the sum of the blocks
    [1, 5, 2, 7] (:120-121; here in the list's order from zeros, as the
    kernel adds)."""
    x = pd.probe_input("cpu")
    xn = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    want = {"A": xn[8:16], "B": xn[24:32],
            "C": sum(xn[i * 8:i * 8 + 8] for i in (1, 5, 2, 7))}[step]
    (_, fn, args, library, _), = [s for s in pd.steps(x) if s[0] == step]
    plain = getattr(pd, fn.__name__ + "_plain")
    launches = fn.launches
    for out in (plain(*args), fn(*args)):
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), want)
    assert fn.launches == launches          # the CPU ran no kernel
    np.testing.assert_array_equal(pd.expected(step), want)
    np.testing.assert_allclose(library().numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("case", [
    ("static", (1, 4)), ("dynamic", [16]), ("worklist", [2, -1])],
    ids=lambda c: c[0])
def test_dma_plain_versions_refuse_blocks_outside_x(case):
    kind, arg = case
    x = pd.probe_input("cpu")
    fn = getattr(pd, f"copy_{kind}_plain")
    with pytest.raises(ValueError, match="outside"):
        if kind == "static":
            fn(x, 62, 8)
        else:
            fn(x, torch.tensor(arg, dtype=torch.int32))


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel's checks (which
    want a CUDA tensor), never to the plain version."""
    x = torch.empty((64, 128), device="meta")
    idx = torch.empty(4, dtype=torch.int32, device="meta")
    for call in (lambda: pd.copy_static(x), lambda: pd.copy_dynamic(x, idx),
                 lambda: pd.copy_worklist(x, idx),
                 lambda: pm.pair_hit_mb(torch.empty((8, 16), device="meta"),
                                        torch.empty((2, 24, 16),
                                                    device="meta"),
                                        idx.view(-1, 4)[:, :3], 3, False)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_dma_probe_entry_point_on_the_cpu(capsys):
    assert pd.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all('"ok": true' in ln for ln in lines[1:])


@pytest.mark.parametrize("block", [(8, 128), (4, 36), (4, 3072)],
                         ids=["probe", "96x36", "48KB"])
def test_worklist_plan_stages(block):
    """P3's stage plan: a stage a block of the list, every one issued
    before any wait, where an H100's 232,448 bytes of opt-in dynamic
    shared memory hold them (a stage is the block and 16 bytes of
    barriers), else a ring of as many stages as fit; in room for one or
    two stages, or less than one (0 stages, launched with one stage's
    bytes: the kernel reports it)."""
    rows, W = block
    nbytes = rows * W * 4
    stage = nbytes + 16
    for n in (1, 4, 32, 64):
        want = {4112: {1: 1, 4: 4, 32: 32, 64: 56},
                592: {1: 1, 4: 4, 32: 32, 64: 64},
                49168: {1: 1, 4: 4, 32: 4, 64: 4}}[stage][n]
        plan = pd.worklist_plan(n, nbytes, 232_448)
        assert plan == dict(stages=want, slices=1, piece_bytes=nbytes,
                            smem_bytes=want * stage)
        for room in (1, 2):
            p = pd.worklist_plan(n, nbytes, room * stage + 15)
            assert p["stages"] == min(n, room)
            assert p["smem_bytes"] == min(n, room) * stage
        p = pd.worklist_plan(n, nbytes, stage - 1)
        assert p["stages"] == 0 and p["smem_bytes"] == stage


def test_worklist_plan_slices_blocks_over_64kb():
    """A block over 64 KB goes through in 64 KB slices (16 float4s for each
    of 256 consumer threads), the list once a slice: 100 KB is two, the
    stages 64 KB and 16 bytes each."""
    plan = pd.worklist_plan(4, 100 * 1024, 232_448)
    assert plan == dict(stages=3, slices=2, piece_bytes=65536,
                        smem_bytes=3 * 65552)
    assert pd.worklist_plan(1, 65536, 232_448)["slices"] == 1
    assert pd.worklist_plan(1, 65552, 232_448)["slices"] == 2


# ---- P4: the run offsets ----

def _probe_starts(items, Bp, n_c):
    """tools/probe_pair_dma.py:269-273 in numpy: items packed as
    (block << 16) | cluster and padded to Bp + n_c with the last one, the
    item blocks with the padding at Bp, and searchsorted over them."""
    n_items = len(items)
    max_items = Bp + n_c
    packed = np.array([(s // SP) << 16 | c for s, _, c in items], np.int64)
    last = packed[max(n_items - 1, 0)] if n_items else 0
    packed = np.concatenate([packed, np.full(max_items - n_items, last)])
    item_block = np.where(np.arange(max_items) < n_items, packed >> 16, Bp)
    starts = np.searchsorted(item_block, np.arange(Bp + 1))
    return starts, (packed & 0xFFFF)[:n_items]


def _runs(layout, rs):
    """Cluster-sorted items [start, end, cluster] over blocks of SP pairs:
    ``one`` run a block, ``many`` runs a block, ``gaps`` blocks with no run
    in the middle and at the tail. A cluster may go on across a block's
    edge."""
    items, n_blocks, cluster = [], 6, 0
    for b in range(4 if layout == "gaps" else n_blocks):
        if layout == "gaps" and b == 1:
            continue
        cuts = ([0, SP] if layout == "one" else
                sorted({0, SP, *rs.integers(1, SP, 7).tolist()}))
        cluster += int(rs.integers(0, 2))
        for i, (s, e) in enumerate(zip(cuts[:-1], cuts[1:])):
            cluster += int(rs.integers(1, 3)) if i else 0
            items.append((b * SP + s, b * SP + e, cluster))
    return items, n_blocks


@pytest.mark.parametrize("layout", ["one", "many", "gaps"])
def test_block_runs_equal_the_probes_offsets(layout):
    items, n_blocks = _runs(layout, np.random.default_rng(3))
    t = torch.tensor(items, dtype=torch.int32)
    starts, clusters = pm.block_runs(t, SP, n_blocks)
    want_starts, want_clusters = _probe_starts(items, n_blocks, 100)
    assert starts.dtype == clusters.dtype == torch.int32
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    np.testing.assert_array_equal(clusters.numpy(), want_clusters)
    if layout == "gaps":
        assert starts[1] == starts[2] and starts[4] == starts[-1] == len(items)


# ---- P4: the plain version against K3's and against Pallas ----

@pytest.fixture(scope="module")
def battlefield():
    return make_battlefield_like(n_objects=20, grid=11)


def _scattered_pairs(cs, n, seed, sp):
    """Pairs of a k = 4 pass over n scattered rays (numpy seed), as
    ``_sparse_pass`` builds them at ``sp``, and the same runs cut into
    items of 1-5 pairs."""
    rs = np.random.default_rng(seed)
    lo, hi = cs.cl_bbmin.amin(0).numpy(), cs.cl_bbmax.amax(0).numpy()
    o = torch.tensor(rs.uniform(lo, hi, (n, 3)), dtype=torch.float32)
    d = rs.normal(size=(n, 3))
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                     dtype=torch.float32)
    tmin = torch.zeros(n)
    tmax = torch.full((n,), 9.0)
    lat_valid, lat_id, _ = sparse._select(cs, o, safe_inv_dir(d), tmin,
                                          tmax, 4)
    cl, ray, rank, _ = sparse._lattice_pairs(lat_valid, lat_id, 4 * n)
    Fp, items = sparse._pair_inputs(o, d, tmin, tmax, cl, ray, rank, sp)
    cuts = []
    for s, e, c in items.tolist():
        while s < e:
            k = min(int(rs.integers(1, 6)), e - s)
            cuts.append((s, s + k, c))
            s += k
    return Fp, items, torch.tensor(cuts, dtype=torch.int32)


@pytest.mark.parametrize("guard", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("C", [6, 16, 128])
def test_pair_hit_mb_plain_equals_pair_hit_plain(battlefield, C, guard):
    """P4's plain version, block by block and run by run, equals K3's plain
    version word for word, on runs of a pass and on the same runs cut into
    items of 1-5 pairs, with clusters of 6, 16 and 128; an item naming no
    cluster of the scene leaves its pairs missed in both."""
    cs = cluster_scene_from_numpy(
        **compile_clusters_np(battlefield, cluster_size=C), device="cpu")
    Fp, items, short = _scattered_pairs(cs, 2048, C, SP)
    col_bits = max((C - 1).bit_length(), 1)
    for it in (items, short):
        want = sparse.pair_hit_plain(Fp, cs.G3, it, col_bits, guard)
        assert (want < sparse._MISS_BITS).any()
        assert torch.equal(pm.pair_hit_mb_plain(Fp, cs.G3, it, col_bits,
                                                guard, sp=SP), want)
        assert torch.equal(pm.pair_hit_mb(Fp, cs.G3, it, col_bits, guard),
                           want)
    ghost = items.clone()
    ghost[::3, 2] = cs.n_clusters
    live = sparse.covered_pairs(Fp, ghost)[0]
    got = pm.pair_hit_mb_plain(Fp, cs.G3, ghost, col_bits, guard, sp=SP)
    assert (got[~live] == sparse._MISS_BITS).all()
    assert torch.equal(got[live], sparse.pair_hit_plain(
        Fp, cs.G3, items, col_bits, guard)[live])


@pytest.fixture(scope="module")
def scenes():
    sd = make_test_scene()
    jcs = compile_clusters(sd, cluster_size=16)
    return sd, jcs, port_scene(jcs)


def _hits(cs, rays, words, cl):
    """Each pair's winner from its packed word (``cl`` the pair's cluster)
    as the engines' hits."""
    C = cs.cluster_size
    hit = words < sparse._MISS_BITS
    slot = torch.where(hit, cl.to(torch.int32) * C + (words & (C - 1)), 0)
    _, tri, t, u, v = dense.reconstruct(cs, rays, slot)
    return dense.make_hits(rays, hit, tri, t, u, v)


@pytest.mark.parametrize("ray_set", ["camera", "random"])
@pytest.mark.parametrize("guard", [False, True], ids=["closest", "any"])
def test_pair_hit_mb_plain_agrees_with_pallas(scenes, ray_set, guard):
    """P4's plain version against the JAX pair kernel (interpret mode,
    HIGHEST) on the same fp32 pair rows and items (tmax 9: the guard
    binds): each pair's hit equal, its winner's t within the JAX kernel's
    ranking noise (``assert_agrees_with_jax``: interpret mode ranks with a
    bf16 reciprocal, so JAX may keep a winner up to 2^-7 farther, never
    nearer) and the same triangle on > 99% of hits."""
    sd, _, cs = scenes
    rays = camera_rays(sd) if ray_set == "camera" else random_rays(1234)
    r = port_rays(rays)
    tmax = torch.full_like(r.tmax, 9.0)
    lat_valid, lat_id, _ = sparse._select(cs, r.o, safe_inv_dir(r.d),
                                          r.tmin, tmax, 4)
    cl, ray, rank, _ = sparse._lattice_pairs(lat_valid, lat_id,
                                             4 * r.o.shape[0])
    Fp, items = sparse._pair_inputs(r.o, r.d, r.tmin, tmax, cl, ray, rank,
                                    SP)
    C = cs.cluster_size
    col_bits = max((C - 1).bit_length(), 1)
    got = pm.pair_hit_mb_plain(Fp, cs.G3, items, col_bits, guard, sp=SP)
    P = Fp.shape[0]
    B = -(-P // SP)
    Fb = torch.zeros((B * SP, 16))
    Fb[:P] = Fp
    jitems = jnp.asarray(((items[:, 0] // SP) << 16 | items[:, 2]).numpy())
    call = pair_call(items.shape[0], B, SP, C, col_bits, HIGHEST, True, guard)
    out = call(jitems, jnp.int32(items.shape[0]),
               jnp.asarray(Fb.numpy().reshape(B, SP, 16).transpose(0, 2, 1)),
               jnp.asarray(cs.G3.numpy()))
    want = torch.tensor(np.asarray(out[:, 0, :]).view(np.int32)
                        .reshape(-1)[:P].copy())
    prays = Rays(r.o[ray], r.d[ray], r.tmin[ray], tmax[ray])
    assert (want < sparse._MISS_BITS).float().mean() > 0.05
    assert_agrees_with_jax(_hits(cs, prays, got, cl),
                           _hits(cs, prays, want, cl))


def test_pair_probe_entry_point_on_the_cpu(capsys):
    """The entry point on a 64x64 frame of the battlefield-like scene in
    one wave of 4096 lanes: P4's plain walk against K3's, word for word
    at every ring depth it tries, on pass 1 of the first bounce and on
    its first restart pass."""
    assert pm.main(["--device", "cpu", "--width", "64", "--height", "64",
                    "--wave-size", "4096", "--stages", "4,2"]) == 0
    out = capsys.readouterr().out
    for shape in ("headline", "narrow"):
        assert f'"shape": "{shape}"' in out
    assert out.count('"stage": "mb_exactness", "n_diff": 0') == 2
    assert out.count('"n_diff_by_stages": {"4": 0, "2": 0}') == 2
    assert out.count('"stage": "pair_kernel_frame_width"') == 2


# ---- P4: the plan of its work (units, shares, clusters staged) ----

@pytest.fixture(scope="module")
def frame_pairs():
    """The entry point's pair arrays on a 64x64 frame of the
    battlefield-like scene in one wave of 4096 lanes."""
    return pm.bounce_pairs("cpu", 64, 64, 4096)


def _grids(units):
    return [1, 2, 7, 132, 396, units, units + 5]


def test_plan_covers_every_unit_once_in_contiguous_shares(frame_pairs):
    """The plan's shares on any grid tile the units [0, total) in order,
    each CTA's share contiguous and within one unit of the others' (K3's
    cut), and the units are the 64-pair pieces of the runs that name a
    cluster of the scene and pairs of the array (an item naming neither
    has none)."""
    Fp, G3, items, _, _ = frame_pairs
    P, n_c, C = Fp.shape[0], G3.shape[0], G3.shape[1] // 4
    runs = (items[:, 1] - items[:, 0]).long()
    total = int(((runs + 63) // 64).sum())
    ghost = items.clone()
    ghost[::5, 2] = n_c
    ghost_total = int(((runs + 63) // 64)[torch.arange(len(runs)) % 5 != 0]
                      .sum())
    for it, want in ((items, total), (ghost, ghost_total)):
        for grid in _grids(want):
            p = pm.plan(it, P, n_c, C, grid)
            shares = p["shares"]
            assert p["units"] == want and shares.shape == (grid, 2)
            assert shares[0, 0] == 0 and shares[-1, 1] == want
            assert torch.equal(shares[1:, 0], shares[:-1, 1])
            sizes = shares[:, 1] - shares[:, 0]
            assert int(sizes.max() - sizes.min()) <= 1
            assert p["ctas"] == int((sizes > 0).sum()) == min(grid, want)


def test_plan_counts_equal_a_brute_recount(frame_pairs):
    """The plan's clusters staged and bytes equal a unit-by-unit recount
    of each CTA's share (a new cluster at the share's first unit and at
    every change), on the runs of a pass and on the same runs cut into
    items of 1-5 pairs, at several grids."""
    Fp, G3, items, _, _ = frame_pairs
    P, n_c, C = Fp.shape[0], G3.shape[0], G3.shape[1] // 4
    rs = np.random.default_rng(5)
    cuts = []
    for s, e, c in items.tolist():
        while s < e:
            k = min(int(rs.integers(1, 6)), e - s)
            cuts.append((s, s + k, c))
            s += k
    for it in (items, torch.tensor(cuts, dtype=torch.int32)):
        unit_cluster = [c for s, e, c in it.tolist()
                        for _ in range(-(-(e - s) // 64))]
        total = len(unit_cluster)
        for grid in _grids(total):
            staged = ctas = 0
            for b in range(grid):
                u0, u1 = total * b // grid, total * (b + 1) // grid
                ctas += u1 > u0
                last = None
                for u in range(u0, u1):
                    staged += unit_cluster[u] != last
                    last = unit_cluster[u]
            p = pm.plan(it, P, n_c, C, grid)
            assert (p["units"], p["ctas"], p["clusters_staged"]) == (
                total, ctas, staged)
            assert p["bytes_staged"] == staged * 4 * C * 48
            assert pm.stage_bytes(C) == 4 * C * 48
