"""The reference against the program's CPU path, the scene generator
against the program's, and the reference's trace against brute force."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench import scene
from rtbench.reference import geometry, render
from rtbench.tests.conftest import CELLS, tiny_run


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_program_on_every_sample(cell):
    result, numbers = tiny_run(cell)
    assert result["correct"] and result["failed"] == 0
    assert numbers["differ_pct"]["value"] == 0
    assert numbers["rays_gap_pct"]["value"] == pytest.approx(0, abs=1e-9)
    assert numbers["image_gap"]["value"] == 0


def test_the_scene_is_the_programs_generator_frozen():
    from rayaccel_tpu_torch.scene.loader import make_battlefield_like
    ours = scene.battlefield_like(7, n_objects=30, grid=31)
    theirs = make_battlefield_like(n_objects=30, grid=31, seed=7)
    for k, v in ours.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, getattr(theirs, k), err_msg=k)
        else:
            assert v == getattr(theirs, k), k


def test_the_lane_order_is_the_programs():
    from rayaccel_tpu_torch.render.tiled import block_swizzle
    pixel, x, y = render.lane_order(100, 37, 1024)
    perm, px, py = block_swizzle(100, 37, len(pixel))
    np.testing.assert_array_equal(pixel, perm)
    np.testing.assert_array_equal(x, px)
    np.testing.assert_array_equal(y, py)


def test_the_trace_is_the_nearest_hit_of_all_triangles():
    arrays = scene.battlefield_like(3, n_objects=12, grid=9)
    geo = geometry.build(arrays, "cpu")
    g = torch.Generator().manual_seed(0)
    n = 500
    o = torch.rand((n, 3), generator=g) * 40 - 20
    o[:, 1] = torch.rand(n, generator=g) * 10 + 2
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    tmin, tmax = torch.full((n,), 1e-3), torch.full((n,), 1e6)
    got = geometry.trace(geo, o, d, tmin, tmax, chunk=128)
    T = geo.v0.shape[0]
    ok, t, _, _ = geometry.intersect(geo, o, d, torch.arange(T).expand(n, T))
    t = torch.where(ok & (t > 1e-3) & (t <= 1e6), t, torch.inf)
    best, _ = t.min(dim=1)
    hit = torch.isfinite(best)
    assert hit.any() and (~hit).any()
    assert torch.equal(got.tri >= 0, hit)
    assert torch.equal(got.t[hit], best[hit])
    assert torch.equal(got.t[~hit], tmax[~hit])


@pytest.mark.parametrize("chunk", [65536, 1000, 7])
def test_the_trace_does_not_depend_on_its_chunk(chunk):
    geo = geometry.build(scene.battlefield_like(5, n_objects=30, grid=21),
                         "cpu")
    g = torch.Generator().manual_seed(2)
    n = 1500
    o = torch.rand((n, 3), generator=g) * 60 - 30
    o[:, 1] = torch.rand(n, generator=g) * 8 + 1
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    tmin, tmax = torch.full((n,), 1e-3), torch.full((n,), 1e6)
    whole = geometry.trace(geo, o, d, tmin, tmax, chunk=n)
    assert (whole.tri >= 0).any() and (whole.tri < 0).any()
    got = geometry.trace(geo, o, d, tmin, tmax, chunk=chunk)
    for field in geometry.TraceResult._fields:
        assert torch.equal(getattr(got, field), getattr(whole, field)), field
    assert torch.equal(geometry.trace(geo, o, d, tmin, tmax).t, whole.t)


def test_the_chunk_is_bounded_by_bytes():
    # Today's scene (72,000 triangles: 563 of the reference's clusters)
    # keeps the fixed chunk; a million triangles (7,889) take about 17,000.
    assert geometry.chunk_rays(563) == geometry.CHUNK
    assert 15000 < geometry.chunk_rays(7889) < 20000
    for n_c in (1, 827, 2049, 7889, 10 ** 5, 10 ** 6):
        c = geometry.chunk_rays(n_c)
        assert 1 <= c <= geometry.CHUNK
        assert c * 4 * n_c <= geometry.ENTRY_BYTES
    assert geometry.chunk_rays(10 ** 9) == 1


def _lanes(sc, n, seed):
    real = torch.nonzero(sc.lane_pixel >= 0).squeeze(1)
    g = torch.Generator().manual_seed(seed)
    return real[torch.randperm(real.numel(), generator=g)[:n]]


@pytest.mark.parametrize("spp", [0, 1, 7, 255, 3999])
def test_the_stratified_jitter_is_the_programs(spp):
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.render.pathtracer import (SAMPLER_SEED,
                                                      _stratified_jitter)
    sc = render.build(scene.battlefield_like(3, n_objects=12, grid=9,
                                             viewport=(1280, 720)),
                      65536, "cpu")
    lanes = _lanes(sc, 4096, spp)
    jx, jy = render.stratified_jitter(sc, lanes, torch.full_like(lanes, spp))
    _, px, py = _stratified_jitter(sc.lane_x[lanes], sc.lane_y[lanes], spp,
                                   rng.PRNGKey(SAMPLER_SEED))
    assert torch.equal(jx, px) and torch.equal(jy, py)
    assert ((jx >= 0) & (jx < 1) & (jy >= 0) & (jy < 1)).all()


def test_the_uniform_jitter_is_the_programs():
    from rayaccel_tpu_torch import rng
    sc = render.build(scene.battlefield_like(3, n_objects=12, grid=9,
                                             viewport=(200, 100)),
                      4096, "cpu")
    key = (123456789, 987654321)
    lanes = _lanes(sc, 1000, 1)
    rows = torch.tensor([key], dtype=torch.int64).expand(lanes.numel(), 2)
    o, d, _, _ = render.primary_rays(sc, rows, lanes)
    o2, d2, _, _ = render.primary_rays(sc, rows, lanes, "uniform",
                                       torch.full_like(lanes, 5))
    assert torch.equal(d, d2) and torch.equal(o, o2)
    jit = rng.uniform(key, (2, sc.wave), device="cpu")
    local = lanes % sc.wave
    origin, view, right, up = sc.camera
    px = sc.lane_x[lanes].to(torch.float32) + jit[0][local]
    py = sc.lane_y[lanes].to(torch.float32) + jit[1][local]
    want = view[None] + right[None] * px[:, None] + up[None] * py[:, None]
    want = want * torch.rsqrt(geometry.dot(want, want))[:, None]
    assert torch.equal(d, want)
