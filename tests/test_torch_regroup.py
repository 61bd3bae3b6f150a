"""The port's regroup against the JAX package's: ``coherence_key`` and the
``regroup_state`` permutation bitwise (narrow and wide lane states, with
ties), the unsort by lane id, and ``whitted_trace_wave`` with its
between-bounce regroup on the 64x64 test scene through the two-class image
gate."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.environment import create_environment as jax_env
from rayaccel_tpu.render import regroup as jax_regroup
from rayaccel_tpu.render.whitted import whitted_trace_wave as jax_wave
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene
from rayaccel_tpu.types import Rays as JaxRays

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.environment import create_environment
from rayaccel_tpu_torch.render import regroup
from rayaccel_tpu_torch.render.tiled import block_swizzle
from rayaccel_tpu_torch.render.whitted import whitted_trace_wave
from rayaccel_tpu_torch.tools.oracle_lib import two_class_gate
from rayaccel_tpu_torch.types import Rays

from tests.torch_helpers import port_scene

torch.set_num_threads(2)

SIZE, TILE = 64, 1024


def _lane_state(seed, n, ncols):
    """Random rays in and around a box, an alive mask and payload columns;
    a fifth of the origins repeat, so live lanes tie on the key too."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-12, 12, (n, 3)).astype(np.float32)
    o[: n // 5] = o[n // 5: 2 * (n // 5)]
    o[-4:] = [[1e30, 0, 0], [-1e30, 5, 5], [np.inf, 1, 1], [0, -np.inf, 0]]
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:8, 0] = 0.0                                   # +0 and -0 octants
    d[4:8, 0] = -0.0
    alive = rs.uniform(size=n) < 0.6
    cols = [rs.uniform(size=(n, 3)).astype(np.float32),
            rs.integers(0, 9, n).astype(np.int32), alive,
            np.arange(n, dtype=np.int32)]
    if ncols:
        cols.append(rs.uniform(size=(n, ncols)).astype(np.float32))
    bmin = np.float32([-10, -1, -10])
    binv = (1.0 / np.maximum(np.float32([20, 0, 25]), 1e-20)).astype(
        np.float32)
    return o, d, alive, cols, bmin, binv


@pytest.mark.parametrize("n", [4096, 1000])
def test_coherence_key_bitwise(n):
    o, d, alive, _, bmin, binv = _lane_state(n, n, 0)
    z = np.zeros(n, np.float32)
    ref = jax_regroup.coherence_key(
        JaxRays(jnp.asarray(o), jnp.asarray(d), z, z), jnp.asarray(alive),
        jnp.asarray(bmin), jnp.asarray(binv))
    got = regroup.coherence_key(
        Rays(torch.tensor(o), torch.tensor(d), torch.tensor(z),
             torch.tensor(z)), torch.tensor(alive), torch.tensor(bmin),
        torch.tensor(binv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy()[~alive] == 0x7FFFFFFF).all()
    assert len(np.unique(got.numpy()[alive])) > 50


@pytest.mark.parametrize("ncols", [0, 90])
def test_regroup_state_permutation_bitwise(ncols):
    """The narrow state rides one multi-operand sort in JAX and the wide
    one (more than 24 columns) a (key, iota) sort and row gathers; the port
    has one path. Every column must come out in JAX's order, bit for bit:
    the lane-id column is the permutation itself."""
    n = 4096
    o, d, alive, cols, bmin, binv = _lane_state(7 + ncols, n, ncols)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.random.default_rng(1).uniform(1, 9, n).astype(np.float32)
    jr = JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                 jnp.asarray(tmax))
    key = jax_regroup.coherence_key(jr, jnp.asarray(alive), jnp.asarray(bmin),
                                    jnp.asarray(binv))
    ref_rays, ref_cols = jax_regroup.regroup_state(
        key, jr, [jnp.asarray(c) for c in cols])
    pr = Rays(*(torch.tensor(np.asarray(a)) for a in jr))
    got_rays, got_cols = regroup.regroup_state(
        torch.tensor(np.asarray(key)), pr, [torch.tensor(c) for c in cols])
    for a, b in zip([*got_rays, *got_cols], [*ref_rays, *ref_cols]):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    perm = got_cols[3].numpy()
    assert sorted(perm.tolist()) == list(range(n))
    n_live = int(alive.sum())
    assert got_cols[2].numpy()[:n_live].all()            # live lanes first
    assert not got_cols[2].numpy()[n_live:].any()
    # Sorting by the carried lane id undoes the permutation.
    _, (back,) = regroup.regroup_state(got_cols[3], got_rays, [got_cols[0]])
    np.testing.assert_array_equal(back.numpy(), cols[0])


def test_whitted_wave_with_regroup_matches_jax():
    """One 4096-lane wave of depth-4 ray trees with shadows, dense
    primaries and sparse bounces, the parked stacks (9 levels: 90 columns)
    moved with the lanes between bounces and only the live prefix traced:
    the two-class gate against the JAX wave with the same key, dropped 0
    on both, rays traced within 0.5%; and inside the port the regroup
    changes no lane's radiance."""
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
    rad, traced, dropped = whitted_trace_wave(*port_args, regroup=True, **kw)
    assert int(dropped) == int(dropped_ref) == 0
    assert abs(int(traced) - int(traced_ref)) <= 0.005 * int(traced_ref)
    img = rad.numpy()[alive]
    gate = two_class_gate(img, np.asarray(ref)[alive])
    assert gate["rmse_trimmed"] < 1e-3 and gate["frac_flip"] < 0.005, gate
    assert np.isfinite(img).all() and img.max() > 0
    flat, traced_flat, _ = whitted_trace_wave(*port_args, regroup=False, **kw)
    np.testing.assert_array_equal(rad.numpy(), flat.numpy())
    assert int(traced) == int(traced_flat)
