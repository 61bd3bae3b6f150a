"""The port's ``utils`` against the JAX package's: image encoding and
metrics byte for byte, the stats window and its printout string for
string, the frame timer, and ``profile_stages``' keys on the CPU."""

import numpy as np
import pytest
import torch

import jax

import rayaccel_tpu as jracc
from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.scene.loader import make_test_scene as jax_test_scene
from rayaccel_tpu.utils import image as jimage
from rayaccel_tpu.utils import stats as jstats
from rayaccel_tpu.utils.profiling import profile_stages as jax_profile

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.scene.loader import make_test_scene
from rayaccel_tpu_torch.utils import image, stats
from rayaccel_tpu_torch.utils.profiling import profile_stages

torch.set_num_threads(2)


def _hdr(seed, shape=(37, 53, 3)):
    """A seeded HDR image with values past the tonemap's clamp."""
    return np.random.default_rng(seed).gamma(1.0, 0.6, shape).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_png_bytes_equal_jax(seed):
    rgb8 = image.tonemap(_hdr(seed), 2)
    assert image.encode_png(rgb8) == jimage.encode_png(rgb8)


def test_write_png_and_pfm_bytes_equal_jax(tmp_path):
    hdr = _hdr(2)
    for ext, ours, theirs in (
            (".pfm", image.write_pfm, jimage.write_pfm),
            (".png", lambda p, a: image.write_png(p, image.tonemap(a, 1)),
             lambda p, a: jimage.write_png(p, jimage.tonemap(a, 1)))):
        a, b = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
        ours(str(a), hdr)
        theirs(str(b), hdr)
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("spp", [1, 3, 16])
def test_tonemap_and_rmse_equal_jax(spp):
    a, b = _hdr(3), _hdr(4)
    np.testing.assert_array_equal(image.tonemap(a, spp),
                                  jimage.tonemap(a, spp))
    assert image.rmse(a, b) == jimage.rmse(a, b)


def test_render_stats_equal_jax():
    """The same records give the same sliding window, summary and
    printout line at every step, across the 32-frame window's edge."""
    rs = np.random.default_rng(5)
    ours, theirs = stats.RenderStats(), jstats.RenderStats()
    for i in range(45):
        rays, secs = int(rs.integers(1, 5_000_000)), float(rs.uniform(1e-3, 0.5))
        ours.record(rays, secs, i + 1)
        theirs.record(rays, secs, i + 1)
        assert ours.format_line() == theirs.format_line()
    assert ours.summary() == theirs.summary()
    assert ours.last.mrays_per_s == theirs.last.mrays_per_s


def test_frame_timer_records_the_frame():
    s = make_test_scene(viewport=(64, 64), max_depth=1)
    ctx = racc.create_context(racc.Configuration(wave_size=4096),
                              device="cpu")
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                              64, 64)
    r = racc.PathTracingRenderer(ctx, cam, s)
    st = stats.RenderStats()
    with stats.FrameTimer(st, r) as ft:
        ft.run(rng.PRNGKey(0))
    assert st.frames == 1 and st.last.spp == 1
    assert st.last.rays_traced == r.rays_traced_total > 0
    assert st.last.seconds > 0


@pytest.fixture(scope="module")
def jax_stage_keys():
    s = jax_test_scene(viewport=(64, 64), max_depth=2)
    cam = JaxCamera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                            64, 64)
    r = jracc.PathTracingRenderer(jracc.create_context(jracc.Configuration(
        backend="mxu", wave_size=4096)), cam, s)
    return set(jax_profile(r, jax.random.PRNGKey(0), iters=1))


@pytest.mark.parametrize("backend", ["pallas", "mxu", "sparse"])
def test_profile_stages_keys_match_jax(backend, jax_stage_keys):
    """The JAX function's stages less its ``regroup_ms`` (the port runs
    no regroup), each finite and >= 0 (the times themselves are the CPU's
    and are not compared)."""
    s = make_test_scene(viewport=(64, 64), max_depth=2)
    ctx = racc.create_context(racc.Configuration(backend=backend,
                                                 wave_size=4096),
                              device="cpu")
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                              64, 64)
    r = racc.PathTracingRenderer(ctx, cam, s)
    r.render_frame(rng.PRNGKey(0))
    before = r.frame_buffer.clone()
    out = profile_stages(r, iters=2)
    assert set(out) == jax_stage_keys - {"regroup_ms"}
    assert len(out) == 4
    assert all(np.isfinite(v) and v >= 0 for v in out.values()), out
    # Profiling reads no accumulation state and changes none.
    assert r.spp == 1 and torch.equal(r.frame_buffer, before)
