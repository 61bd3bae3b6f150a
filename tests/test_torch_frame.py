"""The port's whole frame against the JAX package's: ``pt_trace_frame`` on
the 64x64 test scene (dense primaries, sparse bounces, depth 2, the same
key) through the two-class image gate of ``tools/oracle_lib.py``, the
shrink and no-shrink paths bitwise, and the renderer end to end."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.environment import create_environment as jax_env
from rayaccel_tpu.render.pathtracer import pt_trace_frame as jax_frame
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.render.pathtracer import pt_trace_frame
from rayaccel_tpu_torch.render.tiled import block_swizzle
from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate

from tests.torch_helpers import port_scene

torch.set_num_threads(2)

SIZE, WAVE, TILE, DEPTH = 64, 1024, 512, 2


@pytest.fixture(scope="module")
def frame_inputs():
    sd = make_test_scene(viewport=(SIZE, SIZE), max_depth=DEPTH)
    jcs = compile_clusters(sd, cluster_size=16)
    perm, x, y = block_swizzle(SIZE, SIZE, SIZE * SIZE)
    W = SIZE * SIZE // WAVE
    return sd, jcs, port_scene(jcs), perm, (x.reshape(W, WAVE),
                                            y.reshape(W, WAVE),
                                            (perm >= 0).reshape(W, WAVE))


def _port_frame(sd, cs, xya, seed, **kw):
    """The port's frame on its default engine, "pallas"
    (``test_torch_engine_default.py``)."""
    x, y, a = (torch.as_tensor(v) for v in xya)
    cam = JaxCamera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                            SIZE, SIZE)
    px = sd.env_pixels
    env = create_environment(px, px.shape[1], px.shape[0], device="cpu")
    return pt_trace_frame(
        cs, env, racc.Camera(cam.origin, cam.view, cam.right,
                             cam.up).as_arrays("cpu"),
        x.to(torch.int32), y.to(torch.int32), a, rng.PRNGKey(seed), DEPTH,
        tile=TILE, bounce_backend="sparse", **kw)


def test_frame_matches_jax(frame_inputs):
    sd, jcs, cs, perm, xya = frame_inputs
    cam = JaxCamera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                            SIZE, SIZE)
    px = sd.env_pixels
    ref, traced_ref, dropped_ref = jax_frame(
        jcs, jax_env(px, px.shape[1], px.shape[0]), cam.as_arrays(),
        *(jnp.asarray(v) for v in xya), jax.random.PRNGKey(5), DEPTH,
        backend="pallas", tile=TILE, bounce_backend="sparse")
    rad, traced, dropped = _port_frame(sd, cs, xya, 5)
    assert int(dropped) == int(dropped_ref) == 0
    # Lanes that flip a winner trace a different path length.
    assert abs(int(traced) - int(traced_ref)) <= 0.005 * int(traced_ref)
    valid = perm >= 0
    img = rad.reshape(-1, 3).numpy()[valid]
    gate = two_class_gate(img, np.asarray(ref).reshape(-1, 3)[valid])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    assert np.isfinite(img).all() and img.max() > 0


def test_shrink_matches_no_shrink_bitwise(frame_inputs):
    """The staged width shrink only re-orders lanes: with the lane-keyed
    bounce draws, the shrink path (4096 -> 1024 lanes) and the no-shrink
    path produce the same frame bit for bit."""
    sd, _, cs, _, xya = frame_inputs
    outs = [_port_frame(sd, cs, xya, 9, min_stage_width=msw)
            for msw in (1024, 1 << 30)]
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    assert int(outs[0][1]) == int(outs[1][1])
    assert int(outs[0][2]) == int(outs[1][2]) == 0


def test_renderer_end_to_end(frame_inputs):
    """PathTracingRenderer: the lane-order framebuffer accumulates
    pt_trace_frame's radiance and image() un-permutes it."""
    sd, _, cs, perm, xya = frame_inputs
    cfg = racc.Configuration(wave_size=WAVE, trace_block=TILE)
    ctx = racc.create_context(cfg, device="cpu")
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, SIZE, SIZE)
    r = racc.PathTracingRenderer(ctx, cam, sd, tpu_scene=cs)
    stats = [r.render_frame(rng.PRNGKey(s)) for s in (5, 6)]
    assert r.spp == 2 and r.dropped == 0
    assert r.rays_traced_total == sum(int(s.rays_traced) for s in stats)
    img = r.image()
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()
    frames = [_port_frame(sd, cs, xya, s)[0].reshape(-1, 3).numpy()
              for s in (5, 6)]
    want = np.zeros((SIZE * SIZE, 3), np.float32)
    want[perm[perm >= 0]] = (frames[0] + frames[1])[perm >= 0]
    np.testing.assert_array_equal(img, want.reshape(SIZE, SIZE, 3) / 2)
    assert img.mean() > 0.05       # a lit sky and lit geometry
