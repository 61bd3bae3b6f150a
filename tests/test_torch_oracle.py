"""The port's cross-engine oracle (``rayaccel_tpu_torch/tools/oracle_lib.py``)
and the random draws it needs (``rng.split``, ``rng.normal``) against the
JAX package's, on the CPU.

- ``rng.split`` bitwise equal to ``jax.random.split``; ``rng.normal``
  within 4 float32 ulps of ``jax.random.normal`` (XLA's ``log1p`` and
  torch's round differently; 3 is the most seen on 5 M draws);
- ``run_oracle`` of both packages on the test scene compiled at
  ``cluster_size=32`` with 2,048 rays a set: the same ray sets (sky rays
  bitwise, primary and scattered rays within a few ulps), the same rows
  and keys, every ``hit_agree`` and ``t_within_1e3`` within 0.001 of JAX's
  and both ``ok``. The reference takes its primaries from the middle of a
  1280x720 frame, so the scene is made at that size;
- ``run_image_oracle`` of both at 64x64, 1 spp, depth 2: both pass the
  gate, and the port's production image against JAX's passes it too;
- ``two_class_gate`` equal to the numbers JAX's ``run_image_oracle``
  computes from the same two images.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tools.oracle_lib as jax_oracle
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_test_scene

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.render.tiled import block_swizzle
from rayaccel_tpu_torch.tools import oracle_lib
from tests.torch_helpers import port_scene

N_RAYS = 2048
ROW_TOL = 1e-3          # hit_agree and t_within_1e3, port against JAX


def ulps(a, b):
    """Elementwise |a - b| in float32 ulps of the larger magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_split_equals_jax_bitwise(n, seed):
    key = rng.fold_in(rng.PRNGKey(seed), 1)
    want = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 1),
                            n)
    assert np.array_equal(np.array(rng.split(key, n), np.uint32),
                          np.asarray(want))


@pytest.mark.parametrize("shape", [(4096, 3), (100_000,)])
@pytest.mark.parametrize("seed", [0, 7])
def test_normal_within_4_ulps_of_jax(shape, seed):
    got = rng.normal(rng.PRNGKey(seed), shape, device="cpu").numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.shape == want.shape and got.dtype == np.float32
    assert ulps(got, want).max() <= 4


def test_oracle_bar_is_the_references():
    row = dict(hit_agree=1.0, t_within_1e3=1.0)
    assert oracle_lib.oracle_bar([row])
    assert not oracle_lib.oracle_bar([row, dict(row, hit_agree=0.9995)])
    assert not oracle_lib.oracle_bar([dict(row, t_within_1e3=0.999)])
    oracle_lib.require_oracle_bar("row", dict(row, hit_agree=0.9995))
    with pytest.raises(AssertionError, match="oracle bar"):
        oracle_lib.require_oracle_bar("row", dict(row, t_within_1e3=0.999))


@pytest.fixture(scope="module")
def oracles():
    """Both packages' ``run_oracle`` on the same scene, with the rays each
    traced on ``mxu`` (one set of rays a ray set, in order)."""
    sd = make_test_scene(viewport=(1280, 720))
    jcs = compile_clusters(sd, cluster_size=32)
    cs = port_scene(jcs)
    jax_rays = []
    trace = jax_oracle._trace

    def recording(bk, cs_, rays, tile):
        if bk == "mxu":
            jax_rays.append(rays)
        return trace(bk, cs_, rays, tile)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_oracle, "_trace", recording)
        jax_rows, jax_ok = jax_oracle.run_oracle(jcs, sd, n_rays=N_RAYS)
    rows, ok = oracle_lib.run_oracle(cs, sd, n_rays=N_RAYS)
    sets = list(oracle_lib.ray_sets(cs, sd, N_RAYS))
    return dict(rows=rows, ok=ok, jax_rows=jax_rows, jax_ok=jax_ok,
                sets=sets, jax_rays=jax_rays, jcs=jcs)


def test_oracle_ray_sets_equal_jax(oracles):
    sets, jax_rays = oracles["sets"], oracles["jax_rays"]
    assert [s[0] for s in sets] == ["primary", "scattered", "sky"]
    assert [s[2] for s in sets] == [("pallas", "sparse"), ("sparse",),
                                    ("pallas", "sparse")]
    assert len(jax_rays) == 3
    (_, prim, _), (_, scat, _), (_, sky, _) = sets
    jprim, jscat, jsky = jax_rays
    for got, want in zip(sky, jsky):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in ((prim, jprim), (scat, jscat)):
        np.testing.assert_array_equal(got.tmin.numpy(), np.asarray(want.tmin))
        np.testing.assert_array_equal(got.tmax.numpy(), np.asarray(want.tmax))
    np.testing.assert_array_equal(prim.o.numpy(), np.asarray(jprim.o))
    assert ulps(prim.d.numpy(), jprim.d).max() <= 4
    # Origins: u * (hi - lo) + lo, one rounding from the box's scale.
    box = np.abs(np.asarray(jscat.o)).max()
    assert np.abs(scat.o.numpy() - np.asarray(jscat.o)).max() \
        <= 4 * np.spacing(np.float32(box))
    # Directions: normal's 4 ulps, then the normalisation's rounding.
    assert ulps(scat.d.numpy(), jscat.d).max() <= 8
    # The primaries and the scattered rays hit the scene somewhere; the
    # sky rays miss it.
    for rays, hits in zip(jax_rays, (True, True, False)):
        tri = jax_oracle._trace("mxu", oracles["jcs"], rays, 1024)[0]
        assert (tri >= 0).any() == hits


def test_oracle_rows_equal_jax(oracles):
    rows, jax_rows = oracles["rows"], oracles["jax_rows"]
    assert oracles["ok"] and oracles["jax_ok"]
    assert [(r["rays"], r["engine"]) for r in rows] == \
        [(r["rays"], r["engine"]) for r in jax_rows]
    assert [list(r) for r in rows] == [list(r) for r in jax_rows]
    for got, want in zip(rows, jax_rows):
        assert got["n"] == want["n"] == N_RAYS
        for k in ("hit_agree", "t_within_1e3"):
            assert abs(got[k] - want[k]) <= ROW_TOL, (got, want)
        assert got["overflow"] == 0


@pytest.fixture(scope="module")
def image_oracles():
    """Both packages' ``run_image_oracle`` at 64x64, 1 spp, depth 2, with
    each side's production radiance."""
    jax_pt = importlib.import_module("rayaccel_tpu.render.pathtracer")

    sd = make_test_scene(viewport=(64, 64))
    jcs = compile_clusters(sd, cluster_size=32)
    cs = port_scene(jcs)
    images = {}

    def recording(side, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if kw["backend"] == "pallas":
                images[side] = np.asarray(out[0])[0]
            return out
        return call

    args = dict(n_spp=1, viewport=(64, 64), max_depth=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pt, "pt_trace_frame",
                   recording("jax", jax_pt.pt_trace_frame))
        mp.setattr(oracle_lib, "pt_trace_frame",
                   recording("port", oracle_lib.pt_trace_frame))
        jax_img = jax_oracle.run_image_oracle(jcs, sd, **args)
        img = oracle_lib.run_image_oracle(cs, sd, **args)
    return dict(img=img, jax_img=jax_img, images=images)


def _passes(g):
    return g["rmse_trimmed"] < 1e-3 and g["frac_flip"] < 0.005


def test_image_oracle_passes_like_jax(image_oracles):
    img, jax_img = image_oracles["img"], image_oracles["jax_img"]
    assert _passes(img) and _passes(jax_img)
    for k, v in jax_img.items():
        if k in ("n_pixels", "spp", "viewport", "depth"):
            assert img[k] == v
    assert img["dropped"] == 0
    assert img["prod_seconds"] > 0 and img["ref_seconds"] > 0


def test_production_image_against_jax(image_oracles):
    """The port's production frame against JAX's on the same keys."""
    perm, _, _ = block_swizzle(64, 64, 4096)
    images = image_oracles["images"]
    valid = perm >= 0
    gate = oracle_lib.two_class_gate(images["port"][valid],
                                     images["jax"][valid])
    assert _passes(gate), gate
    assert gate["n_pixels"] == 64 * 64


def test_two_class_gate_equals_jax(monkeypatch):
    """The same two images through JAX's ``run_image_oracle`` (its frame
    function replaced by one returning them) and the port's gate."""
    jax_pt = importlib.import_module("rayaccel_tpu.render.pathtracer")

    rs = np.random.default_rng(11)
    N = 4096
    ref = rs.random((N, 3)).astype(np.float32)
    img = ref + (rs.normal(size=(N, 3)) * 3e-4).astype(np.float32)
    flips = rs.choice(N, 40, replace=False)
    img[flips] += rs.random((40, 3)).astype(np.float32) * 0.5

    def frame(*a, backend, **kw):
        out = img if backend == "pallas" else ref
        return jnp.asarray(out)[None], 0, 0

    monkeypatch.setattr(jax_pt, "pt_trace_frame", frame)
    sd = make_test_scene(viewport=(64, 64))
    want = jax_oracle.run_image_oracle(compile_clusters(sd, cluster_size=32),
                                       sd, n_spp=1, viewport=(64, 64))
    valid = block_swizzle(64, 64, N)[0] >= 0
    got = oracle_lib.two_class_gate(img[valid], ref[valid])
    assert got["frac_flip"] > 0
    for k in ("image_rmse", "rmse_trimmed"):
        assert round(got[k], 8) == want[k]
    for k in ("frac_flip", "max_abs", "frac_gt_1e3"):
        assert round(got[k], 6) == want[k]
    assert got["n_pixels"] == want["n_pixels"]
