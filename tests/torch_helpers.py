"""Shared inputs of the port's comparison tests: one scene and one ray set
handed to both packages (as numpy arrays in between)."""

import numpy as np
import torch

import jax.numpy as jnp

from rayaccel_tpu.camera import Camera, generate_pixel_rays
from rayaccel_tpu.types import make_rays

from rayaccel_tpu_torch.scene.clusters import cluster_scene_from_numpy
from rayaccel_tpu_torch.scene.compile import tpu_scene_from_numpy
from rayaccel_tpu_torch.types import Rays

CLUSTER_FIELDS = ("G", "attrs", "tri_id", "cl_bbmin", "cl_bbmax",
                  "mat_params")


def port_scene(jax_cluster_scene):
    """The port's ClusterScene holding the JAX scene's arrays."""
    return cluster_scene_from_numpy(
        *(np.asarray(getattr(jax_cluster_scene, f)) for f in CLUSTER_FIELDS),
        device="cpu")


def port_tpu_scene(jax_tpu_scene):
    """The port's TpuScene holding the JAX scene's arrays."""
    return tpu_scene_from_numpy(
        *(np.asarray(a) for a in jax_tpu_scene), device="cpu")


def port_rays(rays):
    return Rays(*(torch.tensor(np.asarray(a)) for a in rays))


def camera_rays(sd, n=64):
    """The n x n pixel-centre camera rays of tests/test_trace_sparse.py."""
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         n, n)
    yy, xx = np.mgrid[0:n, 0:n]
    return generate_pixel_rays(cam.as_arrays(), jnp.asarray(xx.ravel()),
                               jnp.asarray(yy.ravel()))


def random_rays(seed, n=4096, tmin=0.0, tmax=1e6):
    """Scattered rays over the test scene (tests/test_trace_sparse.py)."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.2, 6, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return make_rays(jnp.asarray(o), jnp.asarray(d), tmin=tmin, tmax=tmax)


def assert_agrees_with_jax(port_hits, jax_hits):
    """Hit/miss agreement is exact; the winners' t agree within the JAX
    engines' ranking noise. Off the TPU, Pallas interpret mode lowers
    ``pl.reciprocal(approx=True)`` to a bf16 reciprocal, so the JAX engines
    rank near-ties with ~2^-8 relative noise and can keep a winner up to
    ~2^-7 farther than the nearest; the port ranks with an IEEE reciprocal
    and never keeps a farther winner than JAX's beyond float rounding."""
    hit = np.asarray(port_hits.tri) >= 0
    np.testing.assert_array_equal(hit, np.asarray(jax_hits.tri) >= 0)
    t = np.asarray(port_hits.t)[hit]
    tj = np.asarray(jax_hits.t)[hit]
    assert np.all(t <= tj * (1 + 1e-5) + 1e-5)
    assert np.all(tj <= t * (1 + 2.0 ** -7) + 1e-5)
    same = np.asarray(port_hits.tri)[hit] == np.asarray(jax_hits.tri)[hit]
    assert same.mean() > 0.99
