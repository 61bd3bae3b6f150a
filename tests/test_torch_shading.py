"""The port's ray generation and shading against the JAX package's, on the
same numpy inputs: camera rays, the environment lookup, the BSDF sample
and the surface frame from attribute rows.

Tolerances: XLA and torch evaluate rsqrt, acos, sin and cos with
different (few-ulp) approximations, and the port runs acos/sin/cos in
float64 before rounding, so float results agree to a few float32 ulps, not
bitwise. Where a value is built from such a result and a quantity near 1
(directions, normals, probe texels), ``atol=2e-6`` covers ~16 ulps of 1.0.
Integer and boolean outputs (lobe picks, masks) must agree exactly except
where a float lands within that tolerance of a threshold."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera as JaxCamera
from rayaccel_tpu.camera import generate_pixel_rays as jax_rays
from rayaccel_tpu.environment import create_environment as jax_env
from rayaccel_tpu.environment import sample_environment_onehot
from rayaccel_tpu.materials import sample_reflective_diffuse as jax_bsdf
from rayaccel_tpu.render import shading as jax_shading
from rayaccel_tpu.scene.clusters import compile_clusters as jax_compile
from rayaccel_tpu.scene.loader import make_test_scene
from rayaccel_tpu.types import Hits as JaxHits, Rays as JaxRays

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.camera import Camera, generate_pixel_rays
from rayaccel_tpu_torch.environment import (create_environment,
                                            sample_environment)
from rayaccel_tpu_torch.materials import sample_reflective_diffuse
from rayaccel_tpu_torch.render import shading
from rayaccel_tpu_torch.types import Hits, Rays

torch.set_num_threads(2)

ATOL = 2e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _unit(rs, n):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_camera_rays():
    sd = make_test_scene(viewport=(96, 64))
    args = (sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov, 96, 64)
    jcam, cam = JaxCamera.look_at(*args), Camera.look_at(*args)
    for f in ("origin", "view", "right", "up"):
        np.testing.assert_array_equal(getattr(cam, f), getattr(jcam, f))
    yy, xx = np.mgrid[0:64, 0:96]
    x, y = xx.ravel().astype(np.int32), yy.ravel().astype(np.int32)
    ref = jax_rays(jcam.as_arrays(), jnp.asarray(x), jnp.asarray(y),
                   key=jax.random.fold_in(jax.random.PRNGKey(3), 0))
    got = generate_pixel_rays(cam.as_arrays("cpu"), _t(x), _t(y),
                              key=rng.fold_in(rng.PRNGKey(3), 0))
    np.testing.assert_array_equal(got.o.numpy(), np.asarray(ref.o))
    np.testing.assert_allclose(got.d.numpy(), np.asarray(ref.d), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got.tmin.numpy(), np.asarray(ref.tmin))
    np.testing.assert_array_equal(got.tmax.numpy(), np.asarray(ref.tmax))


def test_environment_lookup():
    rs = np.random.default_rng(4)
    px = rs.uniform(0, 2, (32, 64, 4)).astype(np.float32)
    d = _unit(rs, 4096)
    d[:4] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1]]   # singular axes
    ref = sample_environment_onehot(jax_env(px, 64, 32), jnp.asarray(d))
    got = sample_environment(create_environment(px, 64, 32, device="cpu"),
                             _t(d))
    # Probe values up to 2: the bilinear weights' few-ulp differences
    # scale with the texels.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2 * ATOL * 4)


def test_bsdf_sample():
    rs = np.random.default_rng(5)
    n = 8192
    normal = _unit(rs, n)
    wo = _unit(rs, n)
    wo = np.where((np.sum(wo * normal, -1) < 0)[:, None], -wo, wo)
    params = np.concatenate([rs.uniform(0.05, 0.9, (n, 3)),
                             rs.choice([1 / 1.4, 1 / 1.2, 1.5], (n, 1))],
                            axis=1).astype(np.float32)
    rnd = rs.uniform(0, 1, (n, 3)).astype(np.float32)
    ref = jax_bsdf(jnp.asarray(params), jnp.asarray(rnd), jnp.asarray(normal),
                   jnp.asarray(wo))
    got = sample_reflective_diffuse(_t(params), _t(rnd), _t(normal), _t(wo))
    # The Fresnel term hangs on ``kk = eta^2 (cosi^2 - 1) + 1``, a
    # difference of numbers near 1 whose absolute error is a few ulps of 1
    # (8 * 2^-24) however small kk is; ``sqrt(kk)`` turns it into that
    # over sqrt(kk), and the two reflectances have slopes up to ~4 in
    # sqrt(kk). XLA and torch may contract the products differently, so
    # near total internal reflection (eta = 1.5, small kk > 0) the colour's
    # bar grows as 1/sqrt(kk); elsewhere it is the few-ulp bar. The lobe
    # pick compares ``rnd * total`` with three times the Fresnel term: a
    # lane whose float64 margin is inside that bound may pick either lobe,
    # so the direction is compared on the other lanes, which must be all
    # but 0.5%.
    N, Wo = normal.astype(np.float64), wo.astype(np.float64)
    eta = params[:, 3].astype(np.float64)
    cosi = np.maximum((N * Wo).sum(-1), 0.0)
    kk = eta * eta * (cosi * cosi - 1.0) + 1.0
    cost = np.sqrt(np.maximum(kk, 0.0))
    rper = (eta * cosi - cost) / (eta * cosi + cost)
    rpar = -((eta * cost - cosi) / (eta * cost + cosi))
    fresnel = np.where(kk < 0, 1.0, 0.5 * (rpar * rpar + rper * rper))
    e_cancel = 8 * 2.0 ** -24
    fresnel_bound = np.where(kk < -e_cancel, 0.0, 8.0 * np.minimum(
        e_cancel / np.sqrt(np.maximum(kk, 1e-300)), np.sqrt(e_cancel)))
    total = 3.0 * fresnel + params[:, :3].astype(np.float64).sum(-1)
    margin = np.abs(rnd[:, 2].astype(np.float64) * total - 3.0 * fresnel)
    firm = margin > 2.0 * (3.0 * fresnel_bound + ATOL * 4)
    assert firm.mean() > 0.995, (~firm).sum()
    np.testing.assert_allclose(got[0].numpy()[firm], np.asarray(ref[0])[firm],
                               rtol=0, atol=ATOL * 4)
    err = np.abs(got[1].numpy() - np.asarray(ref[1]))[firm]
    bar = (ATOL * 4 * np.abs(np.asarray(ref[1]))[firm]
           + 2.0 * fresnel_bound[firm, None])
    assert (err <= bar).all(), (err / bar).max()
    # Away from total internal reflection the colour keeps its few-ulp bar.
    plain = firm & ((kk > 0.1) | (kk < -0.1))
    assert plain.mean() > 0.9
    np.testing.assert_allclose(got[1].numpy()[plain],
                               np.asarray(ref[1])[plain], rtol=ATOL * 4,
                               atol=4 * e_cancel / np.sqrt(0.1))
    assert not got[2].any() and not np.asarray(ref[2]).any()


def test_surface_from_attrs():
    sd = make_test_scene()
    cs = jax_compile(sd, cluster_size=16)
    attrs_all = np.asarray(cs.attrs)
    rs = np.random.default_rng(6)
    n = 2048
    real = np.flatnonzero(np.asarray(cs.tri_id) >= 0)
    attrs = attrs_all[rs.choice(real, n)]
    u = rs.uniform(0, 0.5, n).astype(np.float32)
    v = rs.uniform(0, 0.5, n).astype(np.float32)
    t = rs.uniform(0.5, 20, n).astype(np.float32)
    o = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = _unit(rs, n)
    tri = np.zeros(n, np.int32)
    mat = np.asarray(cs.mat_params)
    ref = jax_shading.surface_from_attrs(
        jnp.asarray(attrs), jnp.asarray(mat),
        JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.full(n, 1e6)),
        JaxHits(jnp.asarray(tri), jnp.asarray(t), jnp.asarray(u),
                jnp.asarray(v), jnp.zeros((n, 3))))
    got = shading.surface_from_attrs(
        _t(attrs), _t(mat),
        Rays(_t(o), _t(d), torch.zeros(n), torch.full((n,), 1e6)),
        Hits(_t(tri), _t(t), _t(u), _t(v), torch.zeros(n, 3)))
    np.testing.assert_array_equal(got.mat_params.numpy(),
                                  np.asarray(ref.mat_params))
    # ``entering`` and the spawn's side test are signs of three-term dot
    # products that cancel: a lane whose float64 product is within 1e-6
    # (~16 ulps of its terms) of zero may take either sign, so the flags
    # are compared on the other lanes, which must be all but 0.5%.
    firm = np.abs((d.astype(np.float64)
                   * np.asarray(ref.ng, np.float64)).sum(-1)) > 1e-6
    assert firm.mean() > 0.995
    np.testing.assert_array_equal(got.entering.numpy()[firm],
                                  np.asarray(ref.entering)[firm])
    for f, atol in (("ns", ATOL), ("ng", ATOL), ("uv", ATOL),
                    ("d_dot_ng", ATOL), ("pos", 2e-5)):     # |pos| <= ~30
        np.testing.assert_allclose(getattr(got, f).numpy()[firm],
                                   np.asarray(getattr(ref, f))[firm], rtol=0,
                                   atol=atol, err_msg=f)
    # Spawn: the same validity decisions and offset origins.
    wi = _unit(rs, n)
    w = rs.uniform(0, 1, (n, 3)).astype(np.float32)
    jrays, jok = jax_shading.spawn_secondary(
        ref, jnp.asarray(wi), jnp.asarray(w), jnp.zeros(n, bool),
        ref.d_dot_ng)
    rays, ok = shading.spawn_secondary(got, _t(wi), _t(w),
                                       torch.zeros(n, dtype=torch.bool),
                                       got.d_dot_ng)
    firm &= np.abs((wi.astype(np.float64)
                    * np.asarray(ref.ng, np.float64)).sum(-1)) > 1e-6
    assert firm.mean() > 0.995
    np.testing.assert_array_equal(ok.numpy()[firm], np.asarray(jok)[firm])
    np.testing.assert_allclose(rays.o.numpy()[firm],
                               np.asarray(jrays.o)[firm], rtol=0, atol=2e-5)
    old = Rays(_t(o), _t(d), torch.zeros(n), torch.full((n,), 1e6))
    merged = shading.merge_rays(ok, rays, old)
    np.testing.assert_array_equal(merged.d[~ok].numpy(), old.d[~ok].numpy())
    np.testing.assert_array_equal(merged.d[ok].numpy(), rays.d[ok].numpy())
