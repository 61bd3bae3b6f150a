"""The port's host data against the JAX package's, bitwise: synthetic
scenes, the compiled cluster scene, the environment quad table and the
block swizzle. Also: importing the port loads no JAX, configuration
values the port does not run raise, and those it once refused render."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rayaccel_tpu.environment import create_environment as jax_env
from rayaccel_tpu.render.tiled import block_swizzle as jax_swizzle
from rayaccel_tpu.scene import loader as jax_loader
from rayaccel_tpu.scene.bvh import build_bvh as jax_build_bvh
from rayaccel_tpu.scene.clusters import compile_clusters as jax_compile
from rayaccel_tpu.scene.native import build as jax_native

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import Configuration, rng
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.render.tiled import block_swizzle
from rayaccel_tpu_torch.scene import loader
from rayaccel_tpu_torch.scene.bvh import build_bvh
from rayaccel_tpu_torch.scene.clusters import compile_clusters

torch.set_num_threads(2)

SCENES = {
    "test": dict(fn="make_test_scene", kw=dict()),
    "battlefield_small": dict(fn="make_battlefield_like",
                              kw=dict(n_objects=40, grid=21)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    spec = SCENES[request.param]
    return (getattr(jax_loader, spec["fn"])(**spec["kw"]),
            getattr(loader, spec["fn"])(**spec["kw"]))


def test_synthetic_scene_arrays_bitwise(scene_pair):
    ref, port = scene_pair
    for name in ("vertices", "indices", "triangle_materials",
                 "triangle_normals", "normals", "texcoords", "materials",
                 "env_pixels", "cam_origin", "cam_dir", "cam_up"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    assert (port.max_depth, port.viewport_width, port.cam_fov) == \
        (ref.max_depth, ref.viewport_width, ref.cam_fov)


def _same_cluster_scene(ref, cs):
    for name in ("G", "attrs", "tri_id", "cl_bbmin", "cl_bbmax",
                 "mat_params"):
        a = getattr(cs, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        # Compare bit patterns: attrs carry raw int32 words in f32 columns.
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    n_c, C = cs.n_clusters, cs.cluster_size
    assert (n_c, C) == (ref.n_clusters, ref.cluster_size)
    # The kernel layouts are re-arrangements of the same arrays.
    G3_ref = np.asarray(ref.G).reshape(16, n_c, 4 * C).transpose(1, 2, 0)
    np.testing.assert_array_equal(cs.G3.numpy(), G3_ref)
    np.testing.assert_array_equal(cs.bb[:n_c, :3].numpy(),
                                  np.asarray(ref.cl_bbmin))
    assert cs.bb.shape[0] % 128 == 0 and (cs.bb[n_c:] == 3e37).all()


def _compare_cluster_scenes(ref_sd, port_sd, cluster_size):
    """Both packages' cluster compiles, bit for bit, on the BVH of one
    builder. Always on each package's NumPy golden build; on the default
    (native) build too where this process has the JAX package's native
    library loaded: where its build gave up (its compile shares one
    temporary file between processes), its ``compile_clusters`` falls back
    to the NumPy build, whose root box may hold +0.0 where the native one
    holds -0.0, while the port always builds natively."""
    max_leaf = min(cluster_size, 127)
    ref = jax_compile(ref_sd, cluster_size=cluster_size, bvh=jax_build_bvh(
        ref_sd.vertices, np.asarray(ref_sd.indices, np.int64),
        max_leaf=max_leaf, use_native=False))
    cs = compile_clusters(port_sd, cluster_size=cluster_size, bvh=build_bvh(
        port_sd.vertices, np.asarray(port_sd.indices, np.int64),
        max_leaf=max_leaf, use_native=False), device="cpu")
    _same_cluster_scene(ref, cs)
    if jax_native.get_library() is not None:
        _same_cluster_scene(
            jax_compile(ref_sd, cluster_size=cluster_size),
            compile_clusters(port_sd, cluster_size=cluster_size,
                             device="cpu"))


@pytest.mark.parametrize("cluster_size", [16, 128])
def test_cluster_scene_bitwise(scene_pair, cluster_size):
    _compare_cluster_scenes(*scene_pair, cluster_size)


def test_cluster_scene_bitwise_without_the_jax_native_builder(scene_pair,
                                                              monkeypatch):
    """The comparison holds in a worker where the JAX package's native
    build gave up: its builder forced off, it compares the golden path."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_failed", True)
    assert jax_native.get_library() is None
    _compare_cluster_scenes(*scene_pair, 128)


def test_environment_quad_table_bitwise(scene_pair):
    _, sd = scene_pair
    px = sd.env_pixels
    ref = jax_env(px, px.shape[1], px.shape[0])
    env = create_environment(px, px.shape[1], px.shape[0], device="cpu")
    np.testing.assert_array_equal(env.quad.numpy(), np.asarray(ref.quad))
    np.testing.assert_array_equal(env.pixels.numpy(), np.asarray(ref.pixels))


@pytest.mark.parametrize("w,h,pad", [(64, 64, 4096), (320, 180, 65536),
                                     (37, 23, 2048)])
def test_block_swizzle_bitwise(w, h, pad):
    for a, b in zip(block_swizzle(w, h, pad), jax_swizzle(w, h, pad)):
        np.testing.assert_array_equal(a, b)


def test_import_loads_no_jax():
    """The port imports torch and never jax, the JAX package, the repo-root
    ``tools`` package, ``bench`` or ``__graft_entry__``: its benchmark,
    oracle, dry run and probes included."""
    banned = ("jax", "rayaccel_tpu", "tools", "bench", "__graft_entry__")
    code = ("import sys, rayaccel_tpu_torch, rayaccel_tpu_torch.render."
            "pathtracer, rayaccel_tpu_torch.bench, rayaccel_tpu_torch.tools."
            "oracle_lib, rayaccel_tpu_torch.tools.dryrun, "
            "rayaccel_tpu_torch.tools.probe_dma, "
            "rayaccel_tpu_torch.tools.probe_pair_dma; "
            f"banned = {banned!r}; "
            "loaded = [m for m in sys.modules if m in banned or "
            "m.startswith(tuple(b + '.' for b in banned))]; "
            "print(loaded); sys.exit(1 if loaded else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kw", [dict(backend="mxu"),
                                dict(sampler="stratified"),
                                dict(regroup=False),
                                dict(mesh_shape=(1,)),
                                dict(precision="default"),
                                dict(whitted_bounce_scan=1024,
                                     hybrid_tracing=False)])
def test_ported_configuration_renders(kw):
    """Values the port once refused: each builds a context on the CPU and
    renders a finite, lit 64x64 frame with nothing dropped. The scanned
    dense bounce runs on the pooled Whitted loop (4096 lanes, bounces on
    the dense engine in slices of 1024)."""
    sd = loader.make_test_scene(viewport=(64, 64), max_depth=2)
    ctx = racc.create_context(
        Configuration(wave_size=1024, trace_block=512, min_stage_width=1024,
                      **kw), device="cpu")
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 64, 64)
    cls = (racc.WhittedRenderer if "whitted_bounce_scan" in kw
           else racc.PathTracingRenderer)
    r = cls(ctx, cam, sd)
    stats = r.render_frame(rng.PRNGKey(1))
    img = r.image()
    assert r.dropped == 0 and int(stats.rays_traced) >= 64 * 64
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert r.pooled == (kw != dict(regroup=False))
