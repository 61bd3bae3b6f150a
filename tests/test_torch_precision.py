"""``precision="default"`` in the port: the one-pass bf16 product of K1, K4
(``ops/trace_dense.py:_candidates``) and K3
(``ops/trace_sparse.py:pair_hit_plain``).

The plain versions are held against a float64 product of the same
bf16-rounded operands, and against the JAX kernels' own ``pallas_call``
(interpret mode) fed those operands at HIGHEST. JAX on the CPU computes
``Precision.DEFAULT`` as HIGHEST, so the rounding is done before the call;
the product of two bf16 values is exact in float32, so that is what one
bf16 pass computes, up to the order of summation. Then: the knob reaches
every K1, K3 and K4 call of a frame, and "highest" renders what the
default configuration renders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayaccel_tpu.ops.intersect import safe_inv_dir as jax_inv
from rayaccel_tpu.ops.trace_pallas import (_cull_and_queue,
                                           _make_call as dense_call,
                                           _make_occl_call)
from rayaccel_tpu.ops.trace_sparse import _make_call as pair_call
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.ops import trace_dense as dense
from rayaccel_tpu_torch.ops import trace_sparse as sparse
from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
from rayaccel_tpu_torch.scene import loader
from rayaccel_tpu_torch.types import Rays

from tests.torch_helpers import (camera_rays, port_rays, port_scene,
                                 random_rays)

torch.set_num_threads(2)

# Relative margin of a tie. The plain versions sum ten exact products in
# float32 (relative error up to ~2^-21 of the largest product, more where
# the sum cancels) and K3 packs its score with the low 7 mantissa bits
# cleared (2^-16): a decision within 2^-12 of flipping may go either way.
TIE = 2.0 ** -12
TILE = 512
SP = 256
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def scenes():
    sd = make_test_scene()
    jcs = compile_clusters(sd, cluster_size=16)
    return sd, jcs, port_scene(jcs)


@pytest.fixture(scope="module", params=["camera", "random"])
def rays(request, scenes):
    return (camera_rays(scenes[0]) if request.param == "camera"
            else random_rays(1234))


def _bf16(a: torch.Tensor) -> np.ndarray:
    return dense.round_bf16(a).double().numpy()


def _reference(f, g, tmin, tmax=None, strict=False):
    """The decode of float64 products of rows ``f`` (n, 10) with the 4C
    columns ``g`` (4C, 10) (both bf16-rounded): (valid, t, marginal) of
    each (ray, column). ``valid`` is the kernels' test with tmin < t and,
    where tmax is given, t <= tmax (t < tmax if ``strict``); ``marginal``
    marks a column whose test is within TIE of flipping: valid with every
    bound loosened by TIE and not valid with every bound tightened."""
    S = f @ g.T
    C = g.shape[0] // 4
    det, u, v, tn = S[:, :C], S[:, C:2 * C], S[:, 2 * C:3 * C], S[:, 3 * C:]
    ad = np.abs(det)
    neg = np.signbit(det)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(neg, -tn, tn) / ad
    us, vs = np.where(neg, -u, u), np.where(neg, -v, v)
    lo, hi = tmin[:, None], (np.inf if tmax is None else tmax[:, None])

    def test(m):
        """The decode with every bound moved by m (relative)."""
        return ((us >= -m * ad) & (vs >= -m * ad)
                & (np.abs(u + v) <= ad * (1 + m))
                & (t > lo - m * np.abs(t)) & (t <= hi + m * np.abs(t)))

    valid = ((np.signbit(u) == neg) & (np.signbit(v) == neg)
             & (np.abs(u + v) <= ad) & (t > lo)
             & ((t < hi) if strict else (t <= hi)))
    return valid, t, test(TIE) & ~test(-TIE)


def _winners_agree(win, hit, valid, t, marginal):
    """Each ray's winning column (``win`` where ``hit``) against the float64
    reference's: equal except on rays within TIE of a tie (two valid t
    within TIE of the best, or a marginal column at most TIE past it),
    which must be under 2% of the rays. Returns the reference's hit
    fraction."""
    t_ref = np.where(valid, t, np.inf)
    best = t_ref.min(axis=1)
    ref_hit = np.isfinite(best)
    bound = np.where(ref_hit, best * (1 + TIE), np.inf)[:, None]
    near = (((t_ref <= bound) & valid).sum(axis=1) > 1) | (
        marginal & (t <= bound)).any(axis=1)
    ok = (hit == ref_hit) & (~hit | (win == t_ref.argmin(axis=1)))
    assert ok[~near].all(), np.flatnonzero(~ok & ~near)[:10]
    assert near.mean() < 0.02
    return ref_hit.mean()


def test_dense_default_product_against_float64(scenes, rays):
    """``_candidates`` at "default" (K1's and K4's plain product) against
    float64: K1's winning column and K4's any hit in [tmin, 20] per ray
    and cluster."""
    _, _, cs = scenes
    r = port_rays(rays)
    F = dense._ray_features(r.o, r.d)
    C = cs.cluster_size
    f = _bf16(F[:, :10])
    tmin = r.tmin.double().numpy()
    tmax = np.full_like(tmin, 20.0)
    hits = []
    for c in range(cs.n_clusters):
        inside, ad, ts = dense._candidates(F[None, :, :10], cs.G3,
                                           torch.tensor([c]), "default")
        inside, ad, ts = inside[0], ad[0], ts[0]
        g = _bf16(cs.G3[c, :, :10])
        score = ts * torch.reciprocal(ad)
        valid = inside & (score > r.tmin[:, None])
        score = torch.where(valid, score, torch.full_like(score, np.inf))
        hits.append(_winners_agree(score.argmin(dim=1).numpy(),
                                   valid.any(1).numpy(),
                                   *_reference(f, g, tmin)))
        occ = (inside & (ts > ad * r.tmin[:, None])
               & (ts <= ad * 20.0)).any(dim=1).numpy()
        valid_ref, _, marginal = _reference(f, g, tmin, tmax)
        sure = ~marginal.any(axis=1)
        assert (occ == valid_ref.any(axis=1))[sure].all()
        assert sure.mean() > 0.98
    assert max(hits) > 0.1
    # The rounding is real: "highest" gives other products.
    every = (F[None, :, :10].expand(cs.n_clusters, -1, -1).contiguous(),
             cs.G3, torch.arange(cs.n_clusters))
    assert not torch.equal(dense._candidates(*every)[2],
                           dense._candidates(*every, "default")[2])


def _pairs(cs, rays, tmax):
    """The pairs of a k = 4 pass over ``rays`` (each ray's window
    [tmin, tmax]) as ``_sparse_pass`` builds them at SP = 256: (Fp, items,
    pair rays, pair ray index)."""
    r = port_rays(rays)
    tmax = torch.full_like(r.tmax, tmax)
    lat_valid, lat_id, _ = sparse._select(cs, r.o, safe_inv_dir(r.d),
                                          r.tmin, tmax, 4)
    cl, ray, rank, _ = sparse._lattice_pairs(lat_valid, lat_id,
                                             4 * r.o.shape[0])
    Fp, items = sparse._pair_inputs(r.o, r.d, r.tmin, tmax, cl, ray, rank,
                                    SP)
    return Fp, items, Rays(r.o[ray], r.d[ray], r.tmin[ray], tmax[ray]), cl


@pytest.mark.parametrize("guard", [False, True], ids=["closest", "any"])
def test_pair_default_product_against_float64(scenes, rays, guard):
    """``pair_hit_plain`` at "default" against float64: each pair's hit and
    winning column (tmax 9: the guard binds)."""
    _, _, cs = scenes
    Fp, items, _, cl = _pairs(cs, rays, 9.0)
    C = cs.cluster_size
    col_bits = max((C - 1).bit_length(), 1)
    got = sparse.pair_hit_plain(Fp, cs.G3, items, col_bits, guard,
                                precision="default")
    f = _bf16(Fp[:, :10])
    ref = [np.empty((Fp.shape[0], C), dt) for dt in (bool, float, bool)]
    tmin, tmax = Fp[:, 10].double().numpy(), Fp[:, 11].double().numpy()
    for c in range(cs.n_clusters):
        sel = (cl == c).numpy()
        for a, b in zip(ref, _reference(f[sel], _bf16(cs.G3[c, :, :10]),
                                        tmin[sel],
                                        tmax[sel] if guard else None,
                                        strict=True)):
            a[sel] = b
    hit = (got < sparse._MISS_BITS).numpy()
    assert _winners_agree((got & ((1 << col_bits) - 1)).numpy(), hit,
                          *ref) > 0.05
    assert not torch.equal(got, sparse.pair_hit_plain(Fp, cs.G3, items,
                                                      col_bits, guard))


def _hits(cs, rays, slot):
    hit = slot >= 0
    attr, tri, t, u, v = dense.reconstruct(cs, rays, torch.where(hit, slot,
                                                                  0))
    return dense.make_hits(rays, hit, tri, t, u, v)


def _oracle_agree(got, want):
    """``tools/oracle_lib.py:run_oracle``'s measures: hit agreement on >=
    99.95% of rays, t within 1e-3 relative on >= 99.95% of common hits
    (the exact t of each winner: a near-tie, two winners within 1e-3,
    passes) and the same triangle on >= 99%. Off the TPU the JAX kernels
    rank with a bf16 reciprocal (``tests/torch_helpers.py``)."""
    hg, hw = got.tri >= 0, want.tri >= 0
    assert (hg == hw).float().mean() >= 0.9995
    both = hg & hw
    rel = (got.t - want.t).abs() / want.t.abs().clamp_min(1e-6)
    assert (rel[both] < 1e-3).float().mean() >= 0.9995
    assert (got.tri == want.tri)[both].float().mean() >= 0.99


def _jax_dense_inputs(jcs, rays, F, T):
    """JAX's queue of ``rays`` and the bf16-rounded F and G3 in the Pallas
    kernels' layouts."""
    inv = jax_inv(rays.d)
    items, entries, n_items, _ = _cull_and_queue(
        jcs, tuple(rays.o[:, a] for a in range(3)),
        tuple(inv[:, a] for a in range(3)), rays.tmin, rays.tmax, T, TILE)
    Fb = F.clone()
    Fb[:, :10] = dense.round_bf16(F[:, :10])
    Fj = jnp.asarray(Fb.numpy().T.reshape(16, T, TILE).transpose(1, 0, 2))
    n_c, C = jcs.n_clusters, jcs.cluster_size
    G3 = dense.round_bf16(torch.tensor(np.asarray(jcs.G).reshape(
        16, n_c, 4 * C).transpose(1, 2, 0).copy()))
    return items, entries, n_items, Fj, jnp.asarray(G3.numpy())


def test_k1_default_against_pallas(scenes, rays):
    """K1's plain version at "default" against the Pallas kernel on the
    same bf16-rounded operands: hits equal, winners and t as
    ``assert_agrees_with_jax`` holds the engines."""
    _, jcs, cs = scenes
    r = port_rays(rays)
    T = r.o.shape[0] // TILE
    F, q_cl, q_en, q_n, _ = dense._dense_inputs(cs, r, None, TILE, 4, 256)
    got = dense.dense_closest_hit_plain(F, cs.G3, q_cl, q_en, q_n, TILE,
                                        boxes=dense.cluster_boxes(cs),
                                        precision="default")
    call = dense_call(T * 256, T, TILE, cs.cluster_size, HIGHEST, True)
    out = call(*_jax_dense_inputs(jcs, rays, F, T))
    slot = torch.tensor(np.asarray(out[:, 1, :]).view(np.int32).reshape(-1))
    assert (slot >= 0).float().mean() > 0.1
    _oracle_agree(_hits(cs, r, got[1]), _hits(cs, r, slot))


def test_k4_default_against_pallas(scenes, rays):
    """K4's plain version at "default" against the Pallas any-hit kernel
    on the same bf16-rounded operands, window [tmin, 9]: the flags agree
    on >= 99.9% of rays (a ray at a triangle's edge may round apart in the
    two orders of summation)."""
    _, jcs, cs = scenes
    rays = rays._replace(tmax=jnp.full_like(rays.tmax, 9.0))
    r = port_rays(rays)
    T = r.o.shape[0] // TILE
    F, q_cl, q_en, q_n, _ = dense._dense_inputs(cs, r, None, TILE, 4, 256)
    got = dense.dense_occluded_plain(F, cs.G3, q_cl, q_en, q_n, TILE,
                                     boxes=dense.cluster_boxes(cs),
                                     precision="default")
    call = _make_occl_call(T * 256, T, TILE, cs.cluster_size, HIGHEST, True)
    want = np.asarray(call(*_jax_dense_inputs(jcs, rays, F, T))[:, 0, :]
                      ).reshape(-1) > 0
    assert want.any() and not want.all()
    assert (got.numpy() == want).mean() >= 0.999


@pytest.mark.parametrize("guard", [False, True], ids=["closest", "any"])
def test_k3_default_against_pallas(scenes, rays, guard):
    """K3's plain version at "default" against the Pallas pair kernel on
    the same bf16-rounded operands and items: each pair's hit equal, its
    winner and t as ``assert_agrees_with_jax`` holds the engines."""
    _, jcs, cs = scenes
    Fp, items, prays, cl = _pairs(cs, rays, 9.0)
    C = cs.cluster_size
    col_bits = max((C - 1).bit_length(), 1)
    got = sparse.pair_hit_plain(Fp, cs.G3, items, col_bits, guard,
                                precision="default")
    P = Fp.shape[0]
    B = -(-P // SP)
    Fb = torch.zeros((B * SP, 16))
    Fb[:P] = Fp
    Fb[:P, :10] = dense.round_bf16(Fp[:, :10])
    jitems = jnp.asarray(((items[:, 0] // SP) << 16 | items[:, 2]).numpy())
    call = pair_call(items.shape[0], B, SP, C, col_bits, HIGHEST, True, guard)
    G3 = jnp.asarray(dense.round_bf16(cs.G3).numpy())
    out = call(jitems, jnp.int32(items.shape[0]),
               jnp.asarray(Fb.numpy().reshape(B, SP, 16).transpose(0, 2, 1)),
               G3)
    want = torch.tensor(np.asarray(out[:, 0, :]).view(np.int32)
                        .reshape(-1)[:P].copy())

    def slots(words):
        return torch.where(words < sparse._MISS_BITS,
                           cl.to(torch.int32) * C + (words & (C - 1)), -1)

    assert (want < sparse._MISS_BITS).float().mean() > 0.05
    _oracle_agree(_hits(cs, prays, slots(got)), _hits(cs, prays, slots(want)))


@pytest.mark.parametrize("C", [16, 100, 128])
def test_bf16_fragment_copy_reads_back_as_rounded_G3(C):
    """The scene's bf16 copy of G3 for the tensor-core variants of K1 and
    K4 (``ClusterScene.G3b``), read back through the PTX ISA's fragment
    layout of ``mma.sync.m16n8k16`` B (16 x 8, column-major: lane 4g + t
    holds column g, rows 2t, 2t + 1 in its register 0 and 2t + 8, 2t + 9 in
    register 1, the lower row in the low half), with product p's column n
    kind 2p + (n & 1) of triangle 4q + (n >> 1) and a lane's four words its
    registers of product 0, then of product 1, equals ``round_bf16(G3)``
    bit for bit, each element once; triangles past C read as zeros."""
    cs = port_scene(compile_clusters(make_test_scene(), cluster_size=C))
    n_c, groups = cs.n_clusters, -(-C // 4)
    words = cs.G3b.numpy().view(np.uint32)
    assert words.shape == (n_c, groups, 32, 4)
    back = np.zeros((n_c, 4 * C, 16), np.uint32)
    seen = np.zeros((4 * C, 16), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for word in range(4):
            product, reg = divmod(word, 2)
            for half in range(2):
                k = 2 * t + 8 * reg + half
                bits = (words[:, :, lane, word] >> (16 * half)) << 16
                for q in range(groups):
                    tri = 4 * q + g // 2
                    if tri >= C:
                        assert (bits[:, q] == 0).all()
                        continue
                    row = (2 * product + g % 2) * C + tri
                    back[:, row, k] = bits[:, q]
                    seen[row, k] += 1
    assert (seen == 1).all()
    want = dense.round_bf16(cs.G3).numpy().view(np.uint32)
    np.testing.assert_array_equal(back, want)


def _frame(cls, precision, **kw):
    """A renderer of the test scene after one frame at ``precision``."""
    sd = loader.make_test_scene(viewport=(32, 32), max_depth=3)
    cfg = racc.Configuration(wave_size=1024, trace_block=512,
                             min_stage_width=1024,
                             **({} if precision is None
                                else dict(precision=precision)))
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 32, 32)
    r = cls(racc.create_context(cfg, device="cpu"), cam, sd, **kw)
    r.render_frame(rng.PRNGKey(2))
    assert r.dropped == 0
    return r


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("cls,kw", [(racc.PathTracingRenderer, {}),
                                    (racc.WhittedRenderer,
                                     dict(shadows=True))],
                         ids=["pt", "whitted_shadows"])
def test_precision_reaches_every_product(monkeypatch, precision, cls, kw):
    """Every K1, K3 and K4 call of a frame (the plain versions, on the
    CPU) gets the configuration's precision: the path tracer's K1 and K3,
    the Whitted renderer's K1, K4 and both forms of K3. Every call of the
    three wrappers gets the scene's bf16 fragment copy as ``G3b``, which
    their bf16 variants read on a card."""
    seen, fragments = [], []

    def spy(mod, name, log, key):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            log.append((name, k.get(key)))
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((dense, "dense_closest_hit"), (dense, "dense_occluded"),
                      (sparse, "pair_hit")):
        spy(mod, name, fragments, "G3b")
        spy(mod, name + "_plain", seen, "precision")
    r = _frame(cls, precision, **kw)
    names = {"dense_closest_hit_plain", "pair_hit_plain"}
    if kw:
        names.add("dense_occluded_plain")
    assert {n for n, _ in seen} == names
    assert {p for _, p in seen} == {precision}
    assert {n + "_plain" for n, _ in fragments} == names
    assert all(g is r.scene.G3b for _, g in fragments)


def test_highest_frame_equals_the_default_configuration():
    """precision="highest" named renders bit for bit what the default
    configuration renders."""
    np.testing.assert_array_equal(
        _frame(racc.PathTracingRenderer, "highest").image(),
        _frame(racc.PathTracingRenderer, None).image())
