"""The port's public API gaps against the JAX package's: the material
table, ``Camera.rotate`` / ``forward``, the context introspection,
``tile_size`` and the ``end_frame`` hook, ``unpack_attrs_np``,
``pair_leaves_native`` and ``render()``, bitwise where both packages run
the same host NumPy or the same threefry stream."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import rayaccel_tpu as jracc
from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.materials import default_materials as jax_default_materials
from rayaccel_tpu.materials import make_material_table as jax_make_table
from rayaccel_tpu.materials import reflective_diffuse as jax_row
from rayaccel_tpu.scene import loader as jax_loader
from rayaccel_tpu.scene.bvh import KIND_LEAF
from rayaccel_tpu.scene.bvh import build_bvh as jax_build_bvh
from rayaccel_tpu.scene.clusters import compile_clusters as jax_compile
from rayaccel_tpu.scene.clusters import unpack_attrs_np as jax_unpack
from rayaccel_tpu.scene.native import build as jax_native
from rayaccel_tpu.scene.pairs import build_pairs as jax_build_pairs

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.scene.clusters import (compile_clusters_np,
                                               unpack_attrs_np)
from rayaccel_tpu_torch.scene.compile import compile_scene
from rayaccel_tpu_torch.scene.loader import make_test_scene
from rayaccel_tpu_torch.scene.native import (native_available,
                                             pair_leaves_native)

torch.set_num_threads(2)


def test_default_materials_equal_jax():
    np.testing.assert_array_equal(
        racc.default_materials().params.numpy(),
        np.asarray(jax_default_materials().params))
    assert racc.default_materials().params.dtype == torch.float32


@pytest.mark.parametrize("k,eta", [(0.25, 1.5), ((0.9, 0.2, 0.4), 1 / 1.3)])
def test_material_table_construction_equals_jax(k, eta):
    row = racc.reflective_diffuse(k, eta)
    np.testing.assert_array_equal(row, jax_row(k, eta))
    rows = [row, racc.reflective_diffuse(0.5, 1.0)]
    table = racc.make_material_table(rows)
    assert isinstance(table, racc.MaterialTable)
    np.testing.assert_array_equal(table.params.numpy(),
                                  np.asarray(jax_make_table(rows).params))


CAMERA_MOVES = [
    dict(angle=0.3, axis=(0.0, 1.0, 0.0), pivot=None),
    dict(angle=-1.1, axis=(0.2, 0.9, -0.3), pivot=None),
    dict(angle=0.7, axis=(0.0, 1.0, 0.0), pivot=(0.0, 0.8, 0.0)),
    dict(angle=2.5, axis=(1.0, 0.0, 0.5), pivot=(3.0, -1.0, 2.0)),
]


@pytest.mark.parametrize("move", CAMERA_MOVES)
def test_camera_rotate_and_forward_equal_jax(move):
    s = make_test_scene(viewport=(96, 64))
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                              96, 64)
    jcam = JaxCamera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                             96, 64)
    ours = cam.rotate(**move)
    theirs = jcam.rotate(**move)
    for f in ("origin", "view", "right", "up"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
        assert getattr(ours, f).dtype == np.float32
    np.testing.assert_array_equal(ours.forward(), theirs.forward())
    np.testing.assert_array_equal(cam.forward(), jcam.forward())


def test_context_info_and_lifecycle():
    cfg = racc.Configuration(backend="sparse", wave_size=8192,
                             max_rays_in_flight=65536)
    ctx = racc.create_context(cfg, device="cpu")
    got = racc.info(ctx)
    assert isinstance(got, racc.ContextInfo)
    assert dataclasses.asdict(got) == dict(device_count=1, wave_size=8192,
                                           max_rays_in_flight=65536,
                                           backend="sparse")
    jinfo = jracc.info(jracc.create_context(jracc.Configuration(
        backend="sparse", wave_size=8192, max_rays_in_flight=65536)))
    # The JAX context counts every visible device; the port counts the
    # ranks of its mesh, 1 without one.
    assert (dataclasses.asdict(got) | {"device_count": jinfo.device_count}
            == dataclasses.asdict(jinfo))
    assert racc.destroy(ctx) is None
    assert racc.deinit() is None
    assert racc.info(ctx) == got           # destroy leaves the context usable


def test_context_device_count_equals_jax():
    """``Context.device_count``: 1 on one device, as ``info`` reports it and
    as the JAX context on one device counts it."""
    ctx = racc.create_context(device="cpu")
    jctx = jracc.create_context(devices=jax.devices()[:1])
    assert ctx.device_count == 1 == racc.info(ctx).device_count
    assert ctx.device_count == jctx.device_count == jracc.info(
        jctx).device_count


def test_tile_size_and_end_frame_hook():
    assert racc.TiledRenderer.tile_size == jracc.TiledRenderer.tile_size == 128
    s = make_test_scene(viewport=(32, 32), max_depth=1)
    ctx = racc.create_context(racc.Configuration(wave_size=1024,
                                                 backend="mxu"),
                              device="cpu")
    cam = racc.Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                              32, 32)
    seen = []

    class Hooked(racc.PathTracingRenderer):
        def end_frame(self):
            seen.append(self.spp)

    r = Hooked(ctx, cam, s)
    for i in range(3):
        r.render_frame(rng.PRNGKey(i))
    assert seen == [1, 2, 3]


def test_unpack_attrs_np_equals_jax():
    s = make_test_scene()
    ours = compile_clusters_np(s)["attrs"]
    theirs = np.asarray(jax_compile(jax_loader.make_test_scene()).attrs)
    np.testing.assert_array_equal(ours, theirs)
    a, b = unpack_attrs_np(ours), jax_unpack(theirs)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # Every real row's material id decodes to a table row.
    assert set(np.unique(a["mat"][a["mat"] >= 0])) <= set(range(4))


def test_pair_leaves_native_equals_jax():
    """Each leaf of the test scene's BVH paired by the port's native call
    against the JAX package's pairing of that leaf: its NumPy pairing (the
    golden reference of its native one) always, and its native call too
    where this process has the JAX package's library loaded (its build
    shares one temporary file between processes and may have given up)."""
    assert native_available()
    s = jax_loader.make_test_scene()
    v = np.asarray(s.vertices, np.float32)
    idx = np.asarray(s.indices, np.uint32)
    bvh = jax_build_bvh(v, idx, use_native=False)
    ref = jax_build_pairs(bvh, v, idx, use_native=False)
    jax_lib = jax_native.get_library() is not None
    leaves = 0
    for node in range(bvh.node_count):
        if bvh.first[node] == bvh.last[node] or bvh.kind[node] != KIND_LEAF:
            continue
        ids = bvh.prim_order[bvh.first[node]:bvh.last[node]]
        rows, remap = pair_leaves_native(v, idx, ids)
        lo, hi = ref.leaf_first[node], ref.leaf_last[node]
        np.testing.assert_array_equal(rows, ref.pairs[lo:hi])
        np.testing.assert_array_equal(remap, ref.pair_tri[2 * lo:2 * hi])
        if jax_lib:
            jrows, jremap = jax_native.pair_leaves_native(v, idx, ids)
            np.testing.assert_array_equal(rows, jrows)
            np.testing.assert_array_equal(remap, jremap)
        leaves += 1
    assert leaves > 1


@pytest.fixture(scope="module")
def api_scene():
    return make_test_scene(viewport=(32, 32), max_depth=2)


def _pt(scene, **kw):
    ctx = racc.create_context(racc.Configuration(wave_size=1024),
                              device="cpu")
    cam = racc.Camera.look_at(scene.cam_origin, scene.cam_dir, scene.cam_up,
                              scene.cam_fov, 32, 32)
    return ctx, racc.PathTracingRenderer(ctx, cam, scene, **kw)


def test_render_default_key_is_prngkey_of_spp(api_scene):
    ctx, a = _pt(api_scene)
    _, b = _pt(api_scene)
    for _ in range(2):
        racc.render(ctx, None, None, a)
        b.render_frame(rng.PRNGKey(b.spp))
    assert a.spp == b.spp == 2
    assert torch.equal(a.frame_buffer, b.frame_buffer)
    # Passing the bound scene and environment again rebinds nothing.
    scene, env = a.scene, a.environment
    racc.render(ctx, scene, env, a, key=rng.PRNGKey(9))
    assert a.scene is scene and a.environment is env


def test_render_rebinds_environment(api_scene):
    """A new environment handed to render() gives the image a fresh
    renderer on that environment gives, bit for bit."""
    px = np.ascontiguousarray(api_scene.env_pixels[::-1, ::-1] * 1.7)
    ctx, a = _pt(api_scene)
    a.render_frame(rng.PRNGKey(3))
    a.clear()
    env = create_environment(px, px.shape[1], px.shape[0], device="cpu")
    racc.render(ctx, None, env, a, key=rng.PRNGKey(4))
    assert a.environment is env
    _, fresh = _pt(api_scene, environment=create_environment(
        px, px.shape[1], px.shape[0], device="cpu"))
    fresh.render_frame(rng.PRNGKey(4))
    assert torch.equal(a.frame_buffer, fresh.frame_buffer)


def test_render_rebinds_scene(api_scene):
    """A new cluster scene is traced from the next frame on; a scene of
    another engine's family is refused."""
    ctx, a = _pt(api_scene)
    other = make_test_scene(viewport=(32, 32), max_depth=2)
    other.vertices = other.vertices + np.float32(0.25)
    _, fresh = _pt(other)
    racc.render(ctx, fresh.scene, None, a, key=rng.PRNGKey(2))
    assert a.scene is fresh.scene
    fresh.render_frame(rng.PRNGKey(2))
    assert torch.equal(a.frame_buffer, fresh.frame_buffer)
    with pytest.raises(ValueError, match="engine"):
        racc.render(ctx, compile_scene(api_scene, device="cpu"), None, a)


# Every knob the two echoes carry, away from its default.
ECHO_KNOBS = dict(sparse_k_pairs=6, sparse_k_first=2, sparse_pair_budget=5,
                  sparse_sp_tile=512, sparse_max_passes=3,
                  sparse_k_restart=4, pallas_k_step=8, pallas_tile_cap=128,
                  precision="default", min_stage_width=2048,
                  whitted_stage_ratio=4, whitted_hot_levels=2,
                  whitted_bounce_scan=65536, max_shading_depth=6)


@pytest.mark.parametrize("kw", [{}, ECHO_KNOBS], ids=["default", "every"])
def test_configuration_echoes_equal_jax(kw):
    """``Configuration.pool_knobs()`` and ``EngineOpts.as_dict()`` carry the
    JAX package's keys and values (its benchmark's knobs line)."""
    ours, theirs = racc.Configuration(**kw), jracc.Configuration(**kw)
    assert ours.pool_knobs() == theirs.pool_knobs()
    assert ours.engine_opts().as_dict() == theirs.engine_opts().as_dict()
    with pytest.raises(ValueError):
        racc.Configuration(pallas_tile_cap=6)   # validation still runs


def _constructors():
    """Each public constructor with a device argument, as a call of
    ``device`` on a small scene."""
    from rayaccel_tpu_torch.scene.clusters import (cluster_scene_from_numpy,
                                                   compile_clusters)
    from rayaccel_tpu_torch.scene.compile import (compile_scene_np,
                                                  tpu_scene_from_numpy)
    sd = make_test_scene(viewport=(16, 16), max_depth=1)
    px = sd.env_pixels
    return {
        "compile_scene": lambda **d: compile_scene(sd, **d),
        "tpu_scene_from_numpy": lambda **d: tpu_scene_from_numpy(
            **compile_scene_np(sd), **d),
        "compile_clusters": lambda **d: compile_clusters(sd, 16, **d),
        "cluster_scene_from_numpy": lambda **d: cluster_scene_from_numpy(
            **compile_clusters_np(sd, 16), **d),
        "create_environment": lambda **d: create_environment(
            px, px.shape[1], px.shape[0], **d),
    }


@pytest.mark.parametrize("name", ["compile_scene", "tpu_scene_from_numpy",
                                  "compile_clusters",
                                  "cluster_scene_from_numpy",
                                  "create_environment"])
def test_constructors_never_pick_the_cpu(monkeypatch, name):
    """With no CUDA device and no ``device`` a public constructor raises,
    as ``create_context`` does; with ``device="cpu"`` every tensor it
    returns lies on the CPU."""
    make = _constructors()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    out = make(device="cpu")
    assert all(a.device == torch.device("cpu") for a in out)


@pytest.mark.parametrize("name", ["Camera.as_arrays", "rng.uniform",
                                  "rng.normal"])
def test_arrays_and_draws_never_pick_the_cpu(monkeypatch, name):
    """``Camera.as_arrays``, ``rng.uniform`` and ``rng.normal`` follow the
    device rule: with no CUDA device and no ``device`` they raise; with
    ``device="cpu"`` they give the JAX package's values (the camera's
    arrays and the uniform draw bit for bit, the normal draw within 4
    float32 ulps: XLA's ``log1p`` rounds otherwise)."""
    sd = make_test_scene(viewport=(32, 24))
    args = (sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov, 32, 24)
    shape = (257, 3)
    port, want = {
        "Camera.as_arrays": (racc.Camera.look_at(*args).as_arrays,
                             lambda: JaxCamera.look_at(*args).as_arrays()),
        "rng.uniform": (lambda **d: rng.uniform(rng.PRNGKey(5), shape, **d),
                        lambda: jax.random.uniform(jax.random.PRNGKey(5),
                                                   shape)),
        "rng.normal": (lambda **d: rng.normal(rng.PRNGKey(5), shape, **d),
                       lambda: jax.random.normal(jax.random.PRNGKey(5),
                                                 shape)),
    }[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port()
    got = port(device="cpu")
    got, want = ((got,), (want(),)) if torch.is_tensor(got) else (got, want())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == torch.device("cpu") and g.dtype == torch.float32
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if name == "rng.normal":
            ulps = np.abs(g.view(np.int32).astype(np.int64)
                          - w.view(np.int32).astype(np.int64))
            assert ulps.max() <= 4
        else:
            np.testing.assert_array_equal(g.view(np.uint32),
                                          w.view(np.uint32))
