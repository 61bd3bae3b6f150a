"""The port's per-wave path tracer against the JAX package's on the 64x64
test scene: the stratified sampler's draws, ``pt_trace_wave`` (dense
primaries, sparse bounces) against the JAX function with and without its
between-bounce regroup (run in JAX as its own tests run it) through the
two-class image gate, and the per-wave renderer against the pooled one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.environment import create_environment as jax_env
from rayaccel_tpu.render import pathtracer as jax_pt
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.render import pathtracer
from rayaccel_tpu_torch.render.tiled import block_swizzle
from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate

from tests.torch_helpers import port_scene

torch.set_num_threads(2)

SIZE, TILE, DEPTH = 64, 1024, 3


@pytest.fixture(scope="module")
def wave_inputs():
    sd = make_test_scene(viewport=(SIZE, SIZE), max_depth=DEPTH)
    jcs = compile_clusters(sd, cluster_size=16)
    perm, x, y = block_swizzle(SIZE, SIZE, SIZE * SIZE)
    return sd, jcs, port_scene(jcs), perm, x.astype(np.int32), \
        y.astype(np.int32)


def _cams(sd):
    args = (sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov, SIZE, SIZE)
    return (JaxCamera.look_at(*args).as_arrays(),
            racc.Camera.look_at(*args).as_arrays("cpu"))


def _port_wave(sd, cs, perm, x, y, seed, **kw):
    """The port's wave on its default engine, "pallas"
    (``test_torch_engine_default.py``)."""
    px = sd.env_pixels
    return pathtracer.pt_trace_wave(
        cs, create_environment(px, px.shape[1], px.shape[0], device="cpu"),
        _cams(sd)[1],
        torch.tensor(x), torch.tensor(y), torch.tensor(perm >= 0),
        rng.PRNGKey(seed), DEPTH, tile=TILE, bounce_backend="sparse", **kw)


@pytest.mark.parametrize("spp", [0, 1, 7, 1000])
def test_stratified_sampler(wave_inputs, spp):
    """The per-pixel rotation draws are bit for bit ``uniform(fold_in(
    sampler_key, (y << 16) | x), (2,))``. The jitter ``mod(rot + spp * g,
    1)`` is within 2 float32 ulps of JAX's on the circle (XLA may fuse the
    product into the sum; a jitter of 0.99999994 and one of 0 are
    neighbours), and the rays it makes agree wherever it did not wrap."""
    sd, _, _, _, x, y = wave_inputs
    x = np.concatenate([x, [65535, 0, 40000]]).astype(np.int32)   # wide ids
    y = np.concatenate([y, [65535, 65535, 3]]).astype(np.int32)
    skey = jax.random.PRNGKey(0x5EED)
    pix = ((jnp.asarray(y).astype(jnp.uint32) << jnp.uint32(16))
           | jnp.asarray(x).astype(jnp.uint32))
    rot_ref = np.asarray(jax.vmap(lambda p: jax.random.uniform(
        jax.random.fold_in(skey, p), (2,), jnp.float32))(pix))
    rot, jx, jy = pathtracer._stratified_jitter(
        torch.tensor(x), torch.tensor(y), spp,
        rng.PRNGKey(pathtracer.SAMPLER_SEED))
    np.testing.assert_array_equal(rot.numpy().view(np.uint32),
                                  rot_ref.view(np.uint32))

    jcam, cam = _cams(sd)
    ref = jax_pt._primary_rays(jcam, jnp.asarray(x), jnp.asarray(y), None,
                               "stratified", jnp.int32(spp), skey)
    got = pathtracer._primary_rays(cam, torch.tensor(x), torch.tensor(y),
                                   None, "stratified", spp,
                                   rng.PRNGKey(pathtracer.SAMPLER_SEED))
    s_f = jnp.float32(spp)
    wrapped = np.zeros(len(x), bool)
    for j, g, col in ((jx, 0.7548776662466927, 0),
                      (jy, 0.5698402909980532, 1)):
        j_ref = np.asarray(jnp.mod(jnp.asarray(rot_ref[:, col])
                                   + s_f * jnp.float32(g), 1.0))
        j = j.numpy()
        assert ((j >= 0) & (j < 1)).all()
        gap = np.abs(j.astype(np.float64) - j_ref)
        gap = np.minimum(gap, 1.0 - gap)                   # on the circle
        assert gap.max() <= 2 * 2.0 ** -24, gap.max()
        wrapped |= np.abs(j - j_ref) > 0.5
    assert wrapped.mean() < 0.001
    np.testing.assert_allclose(got.d.numpy()[~wrapped],
                               np.asarray(ref.d)[~wrapped], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got.o.numpy(), np.asarray(ref.o))


@pytest.mark.parametrize("regroup", [False, True])
def test_wave_matches_jax(wave_inputs, regroup):
    """Depth 3, the same key: the port's one path against the JAX wave
    with and without its regroup (``regroup`` is the JAX side's): the
    two-class gate, dropped 0 on both, rays traced within 0.5% (a flipped
    winner re-aims a path)."""
    sd, jcs, cs, perm, x, y = wave_inputs
    px = sd.env_pixels
    alive = perm >= 0
    ref, traced_ref, dropped_ref = jax_pt.pt_trace_wave(
        jcs, jax_env(px, px.shape[1], px.shape[0]), _cams(sd)[0],
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(alive),
        jax.random.PRNGKey(11), DEPTH, backend="pallas", tile=TILE,
        regroup=regroup, bounce_backend="sparse")
    rad, traced, dropped = _port_wave(sd, cs, perm, x, y, 11)
    assert int(dropped) == int(dropped_ref) == 0
    assert abs(int(traced) - int(traced_ref)) <= 0.005 * int(traced_ref)
    img = rad.numpy()[alive]
    gate = two_class_gate(img, np.asarray(ref)[alive])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    assert np.isfinite(img).all() and img.max() > 0


def _renderer(sd, **kw):
    ctx = racc.create_context(
        racc.Configuration(wave_size=1024, trace_block=512,
                           min_stage_width=1024, **kw), device="cpu")
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, SIZE, SIZE)
    return racc.PathTracingRenderer(ctx, cam, sd)


@pytest.mark.parametrize("sampler", ["uniform", "stratified"])
def test_per_wave_matches_pooled_at_depth0(wave_inputs, sampler):
    """The pooled frame and the per-wave body derive the same primary
    jitter, so at depth 0, where nothing is shaded, their images are equal
    bit for bit (a per-wave image and a pooled one differ sample by sample
    at depth > 0: the pool's lanes are frame-global)."""
    sd = wave_inputs[0]
    s0 = type(sd)(**{**sd.__dict__, "max_depth": 0})
    imgs = {}
    for regroup in (True, False):
        r = _renderer(s0, regroup=regroup, sampler=sampler)
        assert r.pooled == regroup
        for i in range(2):
            r.render_frame(rng.PRNGKey(11 + i))
        assert r.dropped == 0 and r.spp == 2
        imgs[regroup] = r.image()
    np.testing.assert_array_equal(imgs[True], imgs[False])
    assert imgs[True].mean() > 0.05


def test_per_wave_renderer_is_the_wave_function(wave_inputs):
    """With ``regroup=False`` the renderer's frame is ``pt_trace_wave`` per
    wave with ``fold_in(key, w)``; ``clear``, ``frame_buffer``,
    ``set_frame_buffer`` and ``set_camera`` manage the accumulation."""
    sd, _, _, perm, x, y = wave_inputs
    r = _renderer(sd, regroup=False)
    r.render_frame(rng.PRNGKey(2))
    W = r.n_waves
    px = sd.env_pixels
    env = create_environment(px, px.shape[1], px.shape[0], device="cpu")
    xs, ys = (torch.tensor(v).reshape(W, -1) for v in (x, y))
    alive = torch.tensor(perm >= 0).reshape(W, -1)
    want = torch.stack([
        pathtracer.pt_trace_wave(
            r.scene, env, _cams(sd)[1], xs[w], ys[w], alive[w],
            rng.fold_in(rng.PRNGKey(2), w), DEPTH, backend="pallas",
            tile=512, bounce_backend="sparse")[0]
        for w in range(W)])
    fb = r.frame_buffer.clone()
    np.testing.assert_array_equal(fb.numpy(), want.reshape(-1, 3).numpy())
    r.clear()
    assert r.spp == 0 and not r.frame_buffer.any()
    r.set_frame_buffer(fb.numpy())
    np.testing.assert_array_equal(r.frame_buffer.numpy(), fb.numpy())
    r.spp = 1
    img = r.image()
    r.set_camera(r.camera)
    assert r.spp == 0 and not r.frame_buffer.any()
    assert img.mean() > 0.05
