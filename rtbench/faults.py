"""Faults planted under a run's timed path, to see the check fail: each
takes the renderer after set-up and breaks it in place.

- ``frozen``: every frame returns the state it was given (no radiance,
  no rays);
- ``half``: half of each wave's lanes are left out;
- ``altered``: every closest hit of the dense engine comes back with its
  barycentrics swapped, where the engine produces them.
"""

from __future__ import annotations

import torch


def frozen(renderer):
    def render(key):
        return (torch.zeros((renderer.n_waves, renderer.shard_lanes, 3),
                            device=renderer.device), 0, 0)
    renderer._render = render


def half(renderer):
    renderer._wave_alive[:, renderer.shard_lanes // 2:] = False


def altered(renderer):
    from rayaccel_tpu_torch.render import pathtracer
    trace = pathtracer.trace_dense

    def swapped(*a, **kw):
        res, overflow = trace(*a, **kw)
        hits = res.hits._replace(u=res.hits.v, v=res.hits.u)
        return res._replace(hits=hits), overflow
    pathtracer.trace_dense = swapped
    return lambda: setattr(pathtracer, "trace_dense", trace)


FAULTS = {"frozen": frozen, "half": half, "altered": altered}
