"""The port's ``whitted_trace_wave`` against the JAX package's with its
between-bounce regroup (the parked stacks moved with the lanes, only the
live prefix traced) on the 64x64 test scene through the two-class image
gate: the port has no regroup, and its one path must match the JAX
function's regrouped wave."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.environment import create_environment as jax_env
from rayaccel_tpu.render.whitted import whitted_trace_wave as jax_wave
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.render.tiled import block_swizzle
from rayaccel_tpu_torch.render.whitted import whitted_trace_wave
from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate

from tests.torch_helpers import port_scene

torch.set_num_threads(2)

SIZE, TILE = 64, 1024


def test_whitted_wave_with_regroup_matches_jax():
    """One 4096-lane wave of depth-4 ray trees with shadows, dense
    primaries and sparse bounces; on the JAX side the parked stacks (9
    levels: 90 columns) move with the lanes between bounces and only the
    live prefix is traced: the two-class gate against the JAX wave with the
    same key, dropped 0 on both, rays traced within 0.5%."""
    sd = make_test_scene(viewport=(SIZE, SIZE), max_depth=4)
    jcs = compile_clusters(sd, cluster_size=16)
    cs = port_scene(jcs)
    perm, x, y = block_swizzle(SIZE, SIZE, SIZE * SIZE)
    alive = perm >= 0
    px = sd.env_pixels
    args = (sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov, SIZE, SIZE)
    kw = dict(stack_size=9, backend="pallas", tile=TILE, shadows=True,
              bounce_backend="sparse")
    ref, traced_ref, dropped_ref = jax_wave(
        jcs, jax_env(px, px.shape[1], px.shape[0]),
        JaxCamera.look_at(*args).as_arrays(), jnp.asarray(x, jnp.int32),
        jnp.asarray(y, jnp.int32), jnp.asarray(alive), jax.random.PRNGKey(3),
        4, regroup=True, **kw)
    port_args = (cs, create_environment(px, px.shape[1], px.shape[0],
                                         device="cpu"),
                 racc.Camera.look_at(*args).as_arrays("cpu"),
                 torch.tensor(x, dtype=torch.int32),
                 torch.tensor(y, dtype=torch.int32), torch.tensor(alive),
                 rng.PRNGKey(3), 4)
    rad, traced, dropped = whitted_trace_wave(*port_args, **kw)
    assert int(dropped) == int(dropped_ref) == 0
    assert abs(int(traced) - int(traced_ref)) <= 0.005 * int(traced_ref)
    img = rad.numpy()[alive]
    gate = two_class_gate(img, np.asarray(ref)[alive])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    assert np.isfinite(img).all() and img.max() > 0
