"""The port's scene files against the JAX package's: ``save_scene`` writes
the same bytes, ``load_scene`` reads both packages' files back to the same
arrays, and a loaded scene renders."""

import numpy as np
import pytest
import torch

from rayaccel_tpu.scene import loader as jax_loader

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.scene import loader

torch.set_num_threads(2)

ARRAYS = ("vertices", "indices", "triangle_materials", "triangle_normals",
          "normals", "texcoords", "materials", "env_pixels", "cam_origin",
          "cam_dir", "cam_up")
SCALARS = ("max_depth", "viewport_width", "viewport_height", "cam_fov")

SCENES = {
    "test": lambda m: m.make_test_scene(viewport=(64, 64), max_depth=2),
    "battlefield_small": lambda m: m.make_battlefield_like(n_objects=40,
                                                           grid=21),
}


def _assert_same_scene(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_save_scene_bytes_bitwise(tmp_path, scene):
    """The two packages write one file, byte for byte (a 60-byte header
    and seven arrays in the demo's layout)."""
    ref_path, port_path = tmp_path / "ref.bin", tmp_path / "port.bin"
    jax_loader.save_scene(str(ref_path), SCENES[scene](jax_loader))
    sd = SCENES[scene](loader)
    loader.save_scene(str(port_path), sd)
    data = port_path.read_bytes()
    assert data == ref_path.read_bytes()
    env = sd.env_pixels
    assert len(data) == 60 + sd.triangle_count * (12 + 2 + 16) \
        + sd.vertex_count * (16 + 16 + 8) + env.shape[0] * env.shape[1] * 16


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_load_scene_round_trip(tmp_path, scene):
    """What ``save_scene`` wrote, ``load_scene`` reads back bit for bit,
    from either package's file, as the JAX loader reads it."""
    sd = SCENES[scene](loader)
    path = tmp_path / "scene.bin"
    jax_loader.save_scene(str(path), SCENES[scene](jax_loader))
    got = loader.load_scene(str(path))
    _assert_same_scene(got, jax_loader.load_scene(str(path)))
    _assert_same_scene(got, sd)
    loader.save_scene(str(path), got)
    _assert_same_scene(loader.load_scene(str(path)), sd)


def test_scene_without_camera_or_probe(tmp_path):
    """The defaults a bare scene is written with: a 1x1 black probe, the
    camera at the origin looking down +z."""
    sd = loader.make_test_scene()
    bare = type(sd)(vertices=sd.vertices, indices=sd.indices,
                    triangle_materials=sd.triangle_materials,
                    triangle_normals=sd.triangle_normals, normals=sd.normals,
                    texcoords=sd.texcoords, materials=sd.materials)
    ref = type(jax_loader.make_test_scene())(**bare.__dict__)
    loader.save_scene(str(tmp_path / "a.bin"), bare)
    jax_loader.save_scene(str(tmp_path / "b.bin"), ref)
    assert (tmp_path / "a.bin").read_bytes() == \
        (tmp_path / "b.bin").read_bytes()
    got = loader.load_scene(str(tmp_path / "a.bin"))
    assert got.env_pixels.shape == (1, 1, 4) and not got.env_pixels.any()
    np.testing.assert_array_equal(got.cam_dir, [0, 0, 1])
    np.testing.assert_array_equal(got.vertices, sd.vertices)


def test_loaded_scene_renders(tmp_path):
    """The way a user brings a scene of their own: a file, ``load_scene``,
    a renderer. The frame equals the generated scene's bit for bit."""
    sd = SCENES["test"](loader)
    loader.save_scene(str(tmp_path / "scene.bin"), sd)
    loaded = racc.load_scene(str(tmp_path / "scene.bin"))
    ctx = racc.create_context(
        racc.Configuration(wave_size=1024, trace_block=512,
                           min_stage_width=1024), device="cpu")
    imgs = []
    for scene in (sd, loaded):
        cam = racc.Camera.look_at(scene.cam_origin, scene.cam_dir,
                                  scene.cam_up, scene.cam_fov,
                                  scene.viewport_width, scene.viewport_height)
        r = racc.PathTracingRenderer(ctx, cam, scene)
        r.render_frame(rng.PRNGKey(0))
        assert r.dropped == 0
        imgs.append(r.image())
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].shape == (64, 64, 3) and imgs[0].mean() > 0.05
