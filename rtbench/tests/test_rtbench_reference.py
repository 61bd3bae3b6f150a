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
