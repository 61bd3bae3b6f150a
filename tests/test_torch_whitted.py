"""The port's Whitted renderer against the JAX package's: ``whitted_shade``
on the same surfaces, ``whitted_trace_frame`` on the 64x64 test scene
(dense primaries with K4 shadows, sparse bounces and bounce shadows, the
same key) through the two-class image gate, and the port's own
invariants: shrink and deep-stack-tier re-stagings bitwise, the pooled
frame against the per-wave trees, shadows, and the renderer end to end."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.environment import create_environment as jax_env
from rayaccel_tpu.ops.trace_pallas import trace_mxu_pallas
from rayaccel_tpu.render.shading import surface_from_attrs as jax_surface
from rayaccel_tpu.render.whitted import whitted_shade as jax_shade
from rayaccel_tpu.render.whitted import whitted_trace_frame as jax_frame
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.render.shading import SurfaceSample
from rayaccel_tpu_torch.render.tiled import block_swizzle
from rayaccel_tpu_torch.render.whitted import (whitted_shade,
                                               whitted_trace_frame,
                                               whitted_trace_wave)
from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate

from tests.torch_helpers import camera_rays, port_rays, port_scene

torch.set_num_threads(2)

SIZE, WAVE, TILE = 64, 1024, 512


@pytest.fixture(scope="module")
def frame_inputs():
    sd = make_test_scene(viewport=(SIZE, SIZE), max_depth=8)
    jcs = compile_clusters(sd, cluster_size=16)
    perm, x, y = block_swizzle(SIZE, SIZE, SIZE * SIZE)
    W = SIZE * SIZE // WAVE
    xya = (x.reshape(W, WAVE).astype(np.int32),
           y.reshape(W, WAVE).astype(np.int32), (perm >= 0).reshape(W, WAVE))
    return sd, jcs, port_scene(jcs), perm, xya


def _jax_cam(sd):
    return JaxCamera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                             sd.cam_fov, SIZE, SIZE)


def _port_env(sd):
    px = sd.env_pixels
    return create_environment(px, px.shape[1], px.shape[0], device="cpu")


def _port_cam(sd):
    return racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                               sd.cam_fov, SIZE, SIZE).as_arrays("cpu")


def _port_frame(sd, cs, xya, seed, depth, **kw):
    xs, ys, als = (torch.as_tensor(v) for v in xya)
    return whitted_trace_frame(cs, _port_env(sd), _port_cam(sd), xs, ys, als,
                               rng.PRNGKey(seed), depth, tile=TILE, **kw)


# Error budget of the float32 evaluation of a cancelling difference of
# numbers near 1 (the refraction discriminant below): 8 units of 2^-24.
_E_CANCEL = 8 * 2.0 ** -24


def test_whitted_shade_matches_jax(frame_inputs):
    """Direct light, weights and both child rays of the same surfaces (the
    JAX frames of the test camera's hits, handed to both functions).

    The well-conditioned outputs (direct light, weights, the reflection
    direction, ``tmin`` / ``tmax``) agree to a few float32 ulps. The
    refraction direction does not have one bar: ``r = 1 - eta^2 (1 -
    (d.n)^2)`` is a difference of numbers near 1, so its absolute error is
    a few ulps of 1 (``_E_CANCEL``) however small r is, and ``sqrt(r)``
    turns that into ``_E_CANCEL / sqrt(r)`` (near total internal
    reflection, many ulps). XLA and torch may contract the products and
    sums differently, and XLA's choice depends on the host CPU, so neither
    side is the exact one: both are held to a float64 evaluation of the
    same formula from the shared float32 inputs, with that bound. A flag
    or an origin offset that depends on the sign of a quantity within its
    bound of zero (``r``, or a child direction's side of Ng) is compared
    on the other lanes only, and those lanes must be few (< 0.5% of
    hits), so the comparison cannot go empty."""
    sd, jcs, _, _, _ = frame_inputs
    rays = camera_rays(sd)
    res, _ = trace_mxu_pallas(jcs, rays, tile=512)
    surf = jax_surface(res.attrs, jcs.mat_params, rays, res.hits)
    hit = np.asarray(res.hits.tri) >= 0
    assert hit.mean() > 0.3
    weight = np.random.default_rng(3).uniform(
        0.005, 1.0, (rays.o.shape[0], 3)).astype(np.float32)
    ref = jax_shade(surf, rays, jnp.asarray(weight))
    got = whitted_shade(
        SurfaceSample(*(torch.tensor(np.asarray(a)) for a in surf)),
        port_rays(rays), torch.tensor(weight))
    assert int(np.asarray(ref[5])[hit].sum()) > 100      # refractions

    # float64 evaluation of both child directions from the shared inputs.
    d = np.asarray(rays.d, np.float64)[hit]
    ns = np.asarray(surf.ns, np.float64)[hit]
    ng = np.asarray(surf.ng, np.float64)[hit]
    eta = np.where(np.asarray(surf.entering)[hit], np.float32(1.0 / 1.1),
                   np.float32(1.1)).astype(np.float64)
    dn = (d * ns).sum(-1)
    r = 1.0 - eta * eta * (1.0 - dn * dn)
    refl64 = d - (2.0 * dn)[:, None] * ns
    refr64 = (eta[:, None] * d
              - (eta * dn + np.sqrt(np.maximum(r, 0.0)))[:, None] * ns)
    # |sqrt(max(a, 0)) - sqrt(max(b, 0))| <= min(|a - b| / sqrt(max(a, 0)),
    # sqrt(|a - b|)): the bound grows as 1/sqrt(r) and is capped at r = 0.
    sqrt_bound = np.minimum(
        _E_CANCEL / np.sqrt(np.maximum(r, 1e-300)), np.sqrt(_E_CANCEL))
    few_ulps = 8e-7                  # float32 against float64, |values| <= 2
    tol = {"refl": np.full(len(r), few_ulps), "refr": few_ulps + sqrt_bound}
    # Lanes whose flag hangs on a sign within the bound of zero. Under
    # total internal reflection (r clearly negative) the refraction flag is
    # False whatever the side, and the direction lies in the tangent plane
    # (its side of a flat face is a rounding of 0), so there the flag is
    # compared and the offset origin of the dead ray is not.
    tir = r < -4.0 * _E_CANCEL
    loose, origin = {}, {}
    for name, dir64 in (("refl", refl64), ("refr", refr64)):
        side = (dir64 * ng).sum(-1)
        near = np.abs(side) <= 4.0 * tol[name] * np.abs(ng).sum(-1)
        if name == "refr":
            loose[name] = (near & ~tir) | (np.abs(r) <= 4.0 * _E_CANCEL)
            origin[name] = ~near & ~tir & ~loose[name]
        else:
            loose[name] = near
            origin[name] = ~near
        assert loose[name].mean() < 0.005, (name, loose[name].sum())
        assert origin[name].sum() > 500, (name, origin[name].sum())

    def same(a, b):
        """As tight as XLA against torch gets on well-conditioned values."""
        np.testing.assert_allclose(a, b, rtol=4e-7, atol=2e-7)

    names = ("radiance", "new_weight", "refl", "refl_ok", "refr", "refr_ok")
    out = {n: (a, b) for n, a, b in zip(names, got, ref)}
    for name in ("radiance", "new_weight"):
        a, b = out[name]
        same(a.numpy()[hit], np.asarray(b)[hit])
    for name, dir64 in (("refl", refl64), ("refr", refr64)):
        (a, b), keep = out[name], ~loose[name]
        for side_rays in (a, b):
            dirs = np.asarray(side_rays.d)[hit]
            err = np.abs(dirs - dir64).max(-1)
            assert (err <= tol[name]).all(), (name, (err / tol[name]).max())
        if name == "refl":
            same(a.d.numpy()[hit], np.asarray(b.d)[hit])
        same(a.o.numpy()[hit][origin[name]],
             np.asarray(b.o)[hit][origin[name]])
        for f in ("tmin", "tmax"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
        ok_a, ok_b = out[name + "_ok"]
        np.testing.assert_array_equal(ok_a.numpy()[hit][keep],
                                      np.asarray(ok_b)[hit][keep])


def test_whitted_frame_matches_jax(frame_inputs):
    """Depth 4 with shadows, dense primaries (K4 shadows) and sparse
    bounces (sparse shadows), the same key: the two-class gate, traced
    within 0.5%, dropped 0 on both."""
    sd, jcs, cs, perm, xya = frame_inputs
    px = sd.env_pixels
    ref, traced_ref, dropped_ref = jax_frame(
        jcs, jax_env(px, px.shape[1], px.shape[0]), _jax_cam(sd).as_arrays(),
        *(jnp.asarray(v) for v in xya), jax.random.PRNGKey(5), 4,
        backend="pallas", tile=TILE, bounce_backend="sparse", shadows=True,
        min_stage_width=1024)
    rad, traced, dropped = _port_frame(sd, cs, xya, 5, 4, shadows=True,
                                       min_stage_width=1024)
    assert int(dropped) == int(dropped_ref) == 0
    assert abs(int(traced) - int(traced_ref)) <= 0.005 * int(traced_ref)
    valid = perm >= 0
    img = rad.reshape(-1, 3).numpy()[valid]
    gate = two_class_gate(img, np.asarray(ref).reshape(-1, 3)[valid])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    assert np.isfinite(img).all() and img.max() > 0


@pytest.mark.parametrize("bounce_backend", ["pallas", "mxu"])
def test_scanned_dense_bounce_matches_unscanned(frame_inputs, monkeypatch,
                                                bounce_backend):
    """``bounce_scan=1024`` traces the 4096-lane pool's dense bounces in
    four slices, a pure re-batching: radiance within 2 ulp of the
    unscanned frame (the JAX package's bar, ``tests/test_render.py:
    477-481``) and ``dropped`` equal."""
    from rayaccel_tpu_torch.render import whitted
    sd, _, cs, _, xya = frame_inputs
    trace = whitted._trace_and_surface
    out, widths = {}, {}
    for scan in (None, 1024):
        widths[scan] = set()

        def spy(scene, rays, *a, seen=widths[scan], **kw):
            seen.add(rays.o.shape[0])
            return trace(scene, rays, *a, **kw)
        monkeypatch.setattr(whitted, "_trace_and_surface", spy)
        out[scan] = _port_frame(sd, cs, xya, 8, 4, stack_size=5,
                                bounce_backend=bounce_backend,
                                min_stage_width=1 << 30, bounce_scan=scan)
    assert widths[None] == {WAVE, SIZE * SIZE} and widths[1024] == {WAVE}
    ulp = np.abs(out[1024][0].numpy().view(np.int32).astype(np.int64)
                 - out[None][0].numpy().view(np.int32).astype(np.int64))
    assert ulp.max() <= 2
    assert int(out[1024][2]) == int(out[None][2])


def test_scanned_dense_bounce_matches_jax(frame_inputs):
    """The scanned dense bounce on the ``mxu`` engine against the JAX
    frame with the same knobs and key, through the two-class gate."""
    sd, jcs, cs, perm, xya = frame_inputs
    px = sd.env_pixels
    ref, _, dropped_ref = jax_frame(
        jcs, jax_env(px, px.shape[1], px.shape[0]), _jax_cam(sd).as_arrays(),
        *(jnp.asarray(v) for v in xya), jax.random.PRNGKey(8), 4,
        stack_size=5, backend="mxu", tile=TILE, bounce_backend="mxu",
        min_stage_width=1 << 30, bounce_scan=1024)
    rad, _, dropped = _port_frame(sd, cs, xya, 8, 4, stack_size=5,
                                  backend="mxu", bounce_backend="mxu",
                                  min_stage_width=1 << 30, bounce_scan=1024)
    assert int(dropped) == int(dropped_ref) == 0
    valid = perm >= 0
    img = rad.reshape(-1, 3).numpy()[valid]
    gate = two_class_gate(img, np.asarray(ref).reshape(-1, 3)[valid])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    assert np.isfinite(img).all() and img.max() > 0


def test_shrink_matches_no_shrink_bitwise(frame_inputs):
    """The staged width shrink only moves lanes and their parked stacks:
    the shrink path (4096 -> 2048 -> 1024 lanes) and the no-shrink path
    give the same frame bit for bit."""
    sd, _, cs, _, xya = frame_inputs
    info = {}
    shrink = _port_frame(sd, cs, xya, 4, 4, stack_size=6, shadows=True,
                         min_stage_width=1024, info=info)
    full = _port_frame(sd, cs, xya, 4, 4, stack_size=6, shadows=True,
                       min_stage_width=1 << 30)
    assert info["shrinks"] == 2
    np.testing.assert_array_equal(shrink[0].numpy(), full[0].numpy())
    assert int(shrink[1]) == int(full[1])
    assert int(shrink[2]) == int(full[2]) == 0


def test_deep_stack_tier_and_ratio_bitwise(frame_inputs):
    """``hot_levels=1`` sends every park at level >= 1 through the deep
    tier (moved only when some lane has parked that deep), and a ratio-4
    ladder re-stages the loop: both equal the all-hot frame bit for bit."""
    sd, _, cs, _, xya = frame_inputs
    frames, infos = {}, {}
    for name, kw in (("hot_all", dict(hot_levels=6)),
                     ("hot1", dict(hot_levels=1)),
                     ("hot1_r4", dict(hot_levels=1, stage_ratio=4))):
        infos[name] = {}
        rad, _, dropped = _port_frame(sd, cs, xya, 4, 6, stack_size=6,
                                      min_stage_width=1024,
                                      info=infos[name], **kw)
        assert int(dropped) == 0
        frames[name] = rad.numpy()
    assert infos["hot1"]["deep_hauls"] > 0
    assert infos["hot_all"]["deep_hauls"] == 0
    np.testing.assert_array_equal(frames["hot1"], frames["hot_all"])
    np.testing.assert_array_equal(frames["hot1_r4"], frames["hot_all"])


def test_pooled_matches_per_wave(frame_inputs):
    """Whitted shading draws no random numbers, so the pooled tree loop
    reproduces the per-wave trees (the same primaries, trees and stack
    drain; only the schedule differs)."""
    sd, _, cs, _, xya = frame_inputs
    pooled, traced, _ = _port_frame(sd, cs, xya, 2, 4, shadows=True)
    xs, ys, als = (torch.as_tensor(v) for v in xya)
    env, cam = _port_env(sd), _port_cam(sd)
    waves, n = [], 0
    for w in range(xs.shape[0]):
        rad, tr, dropped = whitted_trace_wave(
            cs, env, cam, xs[w], ys[w], als[w], rng.fold_in(rng.PRNGKey(2), w),
            4, tile=TILE, shadows=True, bounce_backend="sparse")
        assert int(dropped) == 0
        waves.append(rad)
        n += int(tr)
    np.testing.assert_allclose(torch.stack(waves).numpy(), pooled.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert n == int(traced)


def _renderer(sd, cs, **kw):
    ctx = racc.create_context(
        racc.Configuration(wave_size=WAVE, trace_block=TILE,
                           min_stage_width=1024), device="cpu")
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, SIZE, SIZE)
    return racc.WhittedRenderer(ctx, cam, sd, tpu_scene=cs, **kw)


def test_shadows_never_add_light(frame_inputs):
    sd, _, cs, _, _ = frame_inputs
    s1 = type(sd)(**{**sd.__dict__, "max_depth": 1})
    imgs = {}
    for shadows in (False, True):
        r = _renderer(s1, cs, shadows=shadows, primary_only=True)
        r.render_frame(rng.PRNGKey(0))
        assert r.dropped == 0
        imgs[shadows] = r.image()
    assert (imgs[True] <= imgs[False] + 1e-5).all(), \
        "shadows must never add light"
    assert (imgs[False] - imgs[True]).max() > 0.01, \
        "some pixels must be shadowed"


@pytest.mark.parametrize("primary_only", [False, True])
def test_renderer_end_to_end(frame_inputs, primary_only):
    """WhittedRenderer accumulates its frame function's radiance in lane
    order and image() un-permutes it: the pooled tree loop by default,
    the per-wave body with fold_in(key, w) under ``primary_only``."""
    sd, _, cs, perm, xya = frame_inputs
    r = _renderer(sd, cs, shadows=True, primary_only=primary_only)
    assert r.stack_size == 9 and r.bounce_backend == "sparse"
    stats = r.render_frame(rng.PRNGKey(6))
    assert r.spp == 1 and r.dropped == 0
    assert r.rays_traced_total == int(stats.rays_traced)
    img = r.image()
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    if primary_only:
        xs, ys, als = (torch.as_tensor(v) for v in xya)
        frame = torch.stack([
            whitted_trace_wave(cs, _port_env(sd), _port_cam(sd), xs[w], ys[w],
                               als[w], rng.fold_in(rng.PRNGKey(6), w), 8,
                               stack_size=9, tile=TILE, shadows=True,
                               primary_only=True)[0]
            for w in range(xs.shape[0])])
        assert r.last_info == {}
    else:
        frame = _port_frame(sd, cs, xya, 6, 8, shadows=True,
                            min_stage_width=1024)[0]
        assert r.last_info["iterations"] > 0
    want = np.zeros((SIZE * SIZE, 3), np.float32)
    want[perm[perm >= 0]] = frame.reshape(-1, 3).numpy()[perm >= 0]
    np.testing.assert_array_equal(img, want.reshape(SIZE, SIZE, 3))
