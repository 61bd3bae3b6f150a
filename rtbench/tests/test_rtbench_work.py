"""The work a trace layer's function needs repeats exactly, and counts
what its definition says."""

from __future__ import annotations

import torch

from rtbench import scene, work
from rtbench.reference import geometry


def _rays(n=400, seed=1):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * 40 - 20
    o[:, 1] = torch.rand(n, generator=g) * 6 + 1
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    active = torch.rand(n, generator=g) < 0.8
    return o, d, torch.full((n,), 1e-3), torch.full((n,), 1e6), active


def test_the_counts_repeat_exactly():
    geo = geometry.build(scene.battlefield_like(5, n_objects=16, grid=11),
                         "cpu")
    rays = _rays()
    first = work.call_work(geo, *rays, "closest")
    assert first == work.call_work(geo, *rays, "closest")
    assert work.layer_work(geo, [(*rays, "closest")] * 2) == (
        2 * first[0], 2 * first[1])


def test_the_counts_follow_their_definition():
    geo = geometry.build(scene.battlefield_like(5, n_objects=16, grid=11),
                         "cpu")
    o, d, tmin, tmax, active = _rays()
    flop, moved = work.call_work(geo, o, d, tmin, tmax, active, "occlusion")
    o, d, tmin, tmax = o[active], d[active], tmin[active], tmax[active]
    hit = geometry.trace(geo, o, d, tmin, tmax)
    entry = geometry.box_entries(geo, o, d, tmin, tmax)
    within = entry <= hit.t[:, None]
    pairs = int((within.long() * geo.cl_count).sum())
    assert flop == pairs * work.FLOP_PER_TRIANGLE
    touched = within.any(0)
    assert moved == (o.shape[0] * (work.RAY_BYTES + 1)
                     + geo.bbmin.shape[0] * work.BOX_BYTES
                     + int(geo.cl_count[touched].sum()) * work.TRIANGLE_BYTES)
    assert work.bound_by(flop, moved) in ("operations", "bytes")
    assert work.bound_ms(flop, moved) > 0
