"""The port's plain engines and their scene compile against the JAX
package's, on the test scene: the golden BVH build, the pairing and the
compiled ``TpuScene`` arrays bitwise; ``trace_mxu``, ``trace_bvh``,
``trace_bruteforce`` and sparse primaries by hit, t and winner agreement;
the any-hit queries' flags; ``interpolate_surface``; the ``trace``
dispatcher over all five engines; and both renderers on every engine."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayaccel_tpu.ops.bruteforce import trace_bruteforce as jax_bruteforce
from rayaccel_tpu.ops.trace import trace_bvh as jax_trace_bvh
from rayaccel_tpu.ops.trace import trace_occlusion_bvh as jax_occl_bvh
from rayaccel_tpu.ops.trace_mxu import trace_mxu as jax_trace_mxu
from rayaccel_tpu.ops.trace_mxu import trace_occlusion_mxu as jax_occl_mxu
from rayaccel_tpu.ops.trace_sparse import trace_sparse as jax_trace_sparse
from rayaccel_tpu.render.shading import interpolate_surface as jax_interp
from rayaccel_tpu.scene import bvh as jax_bvh
from rayaccel_tpu.scene import compile as jax_compile
from rayaccel_tpu.scene import pairs as jax_pairs
from rayaccel_tpu.scene.clusters import compile_clusters as jax_clusters
from rayaccel_tpu.scene.loader import make_battlefield_like, make_test_scene

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.ops.bruteforce import trace_bruteforce
from rayaccel_tpu_torch.ops.trace import (trace, trace_bvh,
                                          trace_occlusion_bvh)
from rayaccel_tpu_torch.ops.trace_mxu import trace_mxu, trace_occlusion_mxu
from rayaccel_tpu_torch.render.shading import interpolate_surface
from rayaccel_tpu_torch.scene import bvh, compile as port_compile, pairs
from rayaccel_tpu_torch.scene.compile import TpuScene
from rayaccel_tpu_torch.types import Hits

from tests.torch_helpers import (assert_agrees_with_jax, camera_rays,
                                 port_rays, port_scene, port_tpu_scene,
                                 random_rays)

torch.set_num_threads(2)

BVH_FIELDS = ("kind", "first", "last", "parent", "bbmin", "bbmax",
              "prim_order")


def _small_scenes():
    return {"test": make_test_scene(),
            "battlefield_small": make_battlefield_like(n_objects=40, grid=21)}


@pytest.fixture(scope="module", params=["test", "battlefield_small"])
def scene_data(request):
    return _small_scenes()[request.param]


def _same_bits(a, b, name):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                  err_msg=name)


def _same_values(a, b, name):
    """Equal as numbers: the native build and the golden one may differ
    in the sign of a zero bound."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("max_leaf", [4, 64])
def test_golden_bvh_and_pairs_bitwise(scene_data, max_leaf):
    """``build_bvh(use_native=False)`` and ``build_pairs(use_native=False)``
    are the JAX package's NumPy code, array for array; the port's
    native default builds the same tree and pairs, and ``validate_bvh``
    accepts it."""
    sd = scene_data
    verts = np.asarray(sd.vertices, np.float32)
    idx = np.asarray(sd.indices, np.int64)
    ref = jax_bvh.build_bvh(verts, idx, max_leaf=max_leaf, use_native=False)
    got = bvh.build_bvh(verts, idx, max_leaf=max_leaf, use_native=False)
    native = bvh.build_bvh(verts, idx, max_leaf=max_leaf)
    for f in BVH_FIELDS:
        _same_bits(getattr(got, f), getattr(ref, f), f)
        _same_values(getattr(native, f), getattr(ref, f), "native " + f)
    bvh.validate_bvh(got, *bvh.triangle_bounds(verts, idx))
    pref = jax_pairs.build_pairs(ref, verts, idx, use_native=False)
    for use_native in (False, True):
        pgot = pairs.build_pairs(got, verts, idx, use_native=use_native)
        for f in ("pairs", "pair_tri", "leaf_first", "leaf_last"):
            _same_bits(getattr(pgot, f), getattr(pref, f),
                       f"{f} native={use_native}")
    tri, code = pairs.unpack_rotation(pref.pair_tri)
    rtri, rcode = jax_pairs.unpack_rotation(pref.pair_tri)
    np.testing.assert_array_equal(tri, rtri)
    np.testing.assert_array_equal(code, rcode)
    assert code.max() <= 3 and sorted(set(tri.tolist())) == list(range(len(idx)))


def test_compile_scene_bitwise(scene_data):
    ref = jax_compile.compile_scene(scene_data)
    got = port_compile.compile_scene(scene_data, device="cpu")
    assert isinstance(got, TpuScene) and got._fields == ref._fields
    for f in ref._fields:
        _same_bits(getattr(got, f).numpy(), getattr(ref, f), f)
    assert (got.triangle_count, got.node_count, got.pair_count) == \
        (ref.triangle_count, ref.node_count, ref.pair_count)
    for first, count in ((0, 0), (5, 3), ((1 << 24) - 256, 255)):
        assert port_compile.encode_leaf(first, count) == \
            jax_compile.encode_leaf(first, count)
    # Bare geometry: the same arrays as the JAX entry point.
    ctx = racc.create_context(racc.Configuration(), device="cpu")
    bare = port_compile.create_scene(ctx, scene_data.vertices,
                                     scene_data.indices.reshape(-1))
    bare_ref = jax_compile.create_scene(None, scene_data.vertices,
                                        scene_data.indices.reshape(-1))
    for f in ref._fields:
        _same_bits(getattr(bare, f).numpy(), getattr(bare_ref, f),
                   "bare " + f)


@pytest.fixture(scope="module")
def traced():
    """One scene in both forms and both packages, and two ray sets."""
    sd = make_test_scene()
    jts = jax_compile.compile_scene(sd)
    jcs = jax_clusters(sd, cluster_size=16)
    rays = {"camera": camera_rays(sd), "random": random_rays(21)}
    return sd, jts, port_tpu_scene(jts), jcs, port_scene(jcs), rays


ENGINES = {
    "mxu": (lambda s, r: jax_trace_mxu(s["jcs"], r, tile=512).hits,
            lambda s, r: trace_mxu(s["cs"], r, tile=512).hits),
    "xla": (lambda s, r: jax_trace_bvh(s["jts"], r),
            lambda s, r: trace_bvh(s["ts"], r)),
    "bruteforce": (lambda s, r: jax_bruteforce(s["jts"].tri_verts, r),
                   lambda s, r: trace_bruteforce(s["ts"].tri_verts, r)),
    "sparse": (lambda s, r: jax_trace_sparse(s["jcs"], r, sp_tile=512)[0].hits,
               lambda s, r: trace(s["cs"], r, backend="sparse")),
}


@pytest.mark.parametrize("rayset", ["camera", "random"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_matches_jax(traced, engine, rayset):
    """Hit and miss exact, t within ``assert_agrees_with_jax``'s bounds,
    winners > 99%; and against the port's own oracle, t within 1e-3."""
    sd, jts, ts, jcs, cs, rays = traced
    s = dict(jts=jts, ts=ts, jcs=jcs, cs=cs)
    jr = rays[rayset]
    pr = port_rays(jr)
    ref = ENGINES[engine][0](s, jr)
    got = ENGINES[engine][1](s, pr)
    assert_agrees_with_jax(got, ref)
    hit = got.tri.numpy() >= 0
    assert 0.2 < hit.mean() < 1.0
    oracle = trace_bruteforce(ts.tri_verts, pr)
    np.testing.assert_array_equal(hit, oracle.tri.numpy() >= 0)
    np.testing.assert_allclose(got.t.numpy()[hit], oracle.t.numpy()[hit],
                               rtol=1e-3, atol=1e-3)
    # Barycentrics follow the original vertex order on every engine.
    same = hit & (got.tri.numpy() == oracle.tri.numpy())
    assert same[hit].mean() > 0.99
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[same],
                                   getattr(oracle, f).numpy()[same],
                                   rtol=0, atol=2e-3)
    assert (got.t.numpy()[~hit] == pr.tmax.numpy()[~hit]).all()


def test_active_mask_and_env(traced):
    """Inactive lanes are misses with no radiance, active misses carry the
    environment's, on both plain engines."""
    sd, _, ts, _, cs, rays = traced
    pr = port_rays(rays["random"])
    n = pr.o.shape[0]
    active = torch.tensor(np.random.default_rng(2).uniform(size=n) < 0.7)
    px = sd.env_pixels
    env = racc.create_environment(px, px.shape[1], px.shape[0], device="cpu")
    for got, full in (
            (trace_mxu(cs, pr, env=env, active=active, tile=512).hits,
             trace_mxu(cs, pr, tile=512).hits),
            (trace_bvh(ts, pr, env=env, active=active), trace_bvh(ts, pr))):
        assert (got.tri[~active] == -1).all()
        np.testing.assert_array_equal(got.tri[active].numpy(),
                                      full.tri[active].numpy())
        lit = (got.miss_rgb.sum(dim=1) > 0).numpy()
        np.testing.assert_array_equal(
            lit, (active & (got.tri < 0)).numpy())


@pytest.mark.parametrize("engine", ["mxu", "xla"])
def test_occlusion_matches_jax(traced, engine):
    """Shadow-like rays over a short range: the flags equal JAX's on at
    least 99.95% of rays (an edge-on test may go either way), inactive
    lanes are never occluded, and an occluded ray has a closest hit."""
    _, jts, ts, jcs, cs, _ = traced
    jr = random_rays(33, tmin=1e-3, tmax=6.0)
    pr = port_rays(jr)
    n = pr.o.shape[0]
    active = np.random.default_rng(5).uniform(size=n) < 0.8
    if engine == "mxu":
        ref = jax_occl_mxu(jcs, jr, active=jnp.asarray(active), tile=512)
        got = trace_occlusion_mxu(cs, pr, active=torch.tensor(active),
                                  tile=512)
    else:
        ref = jax_occl_bvh(jts, jr, active=jnp.asarray(active))
        got = trace_occlusion_bvh(ts, pr, active=torch.tensor(active))
    got = got.numpy()
    assert (got == np.asarray(ref)).mean() >= 0.9995
    assert not got[~active].any() and 0.1 < got[active].mean() < 0.9
    closest = trace_bruteforce(ts.tri_verts, pr).tri.numpy() >= 0
    assert (got[active] == closest[active]).mean() >= 0.9995


def test_interpolate_surface_matches_jax(traced):
    """The gathered shading frame of the lockstep engine's hits: a few
    float32 ulps on values of size ~1 (``atol=2e-6``), positions (|pos| up
    to ~30) to 2e-5, material rows exact. ``entering`` is the sign of a
    three-term product that cancels, so it (and the normal it flips) is
    compared where the float64 product is further than 1e-6 from zero:
    all but 0.5% of the lanes."""
    _, jts, ts, _, _, rays = traced
    jr = rays["camera"]
    pr = port_rays(jr)
    jh = jax_trace_bvh(jts, jr)
    active = np.asarray(jh.tri) >= 0
    ref = jax_interp(jts, jr, jh, jnp.asarray(active))
    hits = Hits(*(torch.tensor(np.asarray(a)) for a in jh))
    got = interpolate_surface(ts, pr, hits, torch.tensor(active))
    firm = active & (np.abs((np.asarray(jr.d, np.float64)
                             * np.asarray(ref.ng, np.float64)).sum(-1)) > 1e-6)
    assert firm.sum() > 0.995 * active.sum() > 1000
    np.testing.assert_array_equal(got.mat_params.numpy()[active],
                                  np.asarray(ref.mat_params)[active])
    np.testing.assert_array_equal(got.ng.numpy()[active],
                                  np.asarray(ref.ng)[active])
    np.testing.assert_array_equal(got.entering.numpy()[firm],
                                  np.asarray(ref.entering)[firm])
    for f, atol in (("ns", 2e-6), ("uv", 2e-6), ("d_dot_ng", 2e-6),
                    ("pos", 2e-5)):
        np.testing.assert_allclose(getattr(got, f).numpy()[firm],
                                   np.asarray(getattr(ref, f))[firm], rtol=0,
                                   atol=atol, err_msg=f)


def test_trace_dispatcher_serves_all_engines(traced):
    sd, _, ts, _, cs, rays = traced
    pr = port_rays(rays["camera"])
    px = sd.env_pixels
    env = racc.create_environment(px, px.shape[1], px.shape[0], device="cpu")
    oracle = trace(ts, pr, env=env, backend="bruteforce")
    miss = oracle.tri.numpy() < 0
    assert (oracle.miss_rgb.numpy()[miss].sum(-1) > 0).all()
    assert not oracle.miss_rgb.numpy()[~miss].any()
    for backend, scene in (("xla", ts), ("mxu", cs), ("pallas", cs),
                           ("sparse", cs)):
        got = racc.trace(scene, pr, env=env, backend=backend)
        np.testing.assert_array_equal(got.tri.numpy() < 0, miss, backend)
        np.testing.assert_allclose(got.miss_rgb.numpy(),
                                   oracle.miss_rgb.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.t.numpy()[~miss],
                                   oracle.t.numpy()[~miss], rtol=1e-3,
                                   atol=1e-3)
    with pytest.raises(ValueError, match="unknown backend"):
        trace(ts, pr, backend="embree")


@pytest.mark.parametrize("regroup", [True, False])
@pytest.mark.parametrize("backend", ["pallas", "mxu", "sparse", "xla"])
def test_renderers_on_every_engine(backend, regroup):
    """Both renderers render the 64x64 test scene on every engine the
    configuration names, pooled and per wave, with nothing dropped; the
    engines' images agree up to edge-tie forks (``tests/test_render.py``:
    under 0.5% of pixels fork, the rest to an RMSE of 1e-3)."""
    sd = make_test_scene(viewport=(64, 64), max_depth=3)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 64, 64)

    def render(cls, bk, **kw):
        ctx = racc.create_context(
            racc.Configuration(backend=bk, regroup=regroup, wave_size=1024,
                               trace_block=512, min_stage_width=1024),
            device="cpu")
        r = cls(ctx, cam, sd, **kw)
        for i in range(2):
            r.render_frame(rng.PRNGKey(i))
        assert r.dropped == 0 and r.spp == 2
        assert r.pooled == (regroup and bk != "xla")
        assert r.bounce_backend == ("sparse" if bk in ("pallas", "mxu")
                                    else bk)
        img = r.image()
        assert np.isfinite(img).all() and img.mean() > 0.05
        return img

    for cls, kw in ((racc.PathTracingRenderer, {}),
                    (racc.WhittedRenderer, dict(shadows=True))):
        img = render(cls, backend, **kw)
        if backend != "pallas" and not (cls is racc.PathTracingRenderer
                                        and backend == "xla" and regroup):
            # (the xla engine renders per wave, whose samples differ from
            # the pooled frame's draw by draw)
            d = np.abs(img - render(cls, "pallas", **kw)).max(-1).ravel()
            forked = d > 1e-2
            assert forked.mean() < 0.005
            assert np.sqrt(np.mean(d[~forked] ** 2)) < 1e-3


def test_renderer_engine_choice(traced):
    """A scene handed in decides the engine family, as in the JAX
    renderers; the brute-force oracle runs no renderer (in the JAX package
    it compiles a TpuScene and then fails inside ``trace_mxu``)."""
    sd, _, ts, _, cs, _ = traced
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 128, 128)

    def ctx(backend):
        return racc.create_context(racc.Configuration(backend=backend),
                                   device="cpu")

    for cls in (racc.PathTracingRenderer, racc.WhittedRenderer):
        assert cls(ctx("pallas"), cam, sd, tpu_scene=ts).backend == "xla"
        assert cls(ctx("xla"), cam, sd, tpu_scene=cs).backend == "mxu"
        assert cls(ctx("sparse"), cam, sd, tpu_scene=cs).backend == "sparse"
        assert isinstance(cls(ctx("xla"), cam, sd).scene, TpuScene)
        with pytest.raises(ValueError, match="bruteforce"):
            cls(ctx("bruteforce"), cam, sd)
