"""Core SoA data types for ray streams, as NamedTuples of tensors.

Counterpart of ``rayaccel_tpu/types.py``: the same fields and layouts
(``(R, 3)`` / ``(R,)`` float32 arrays), held as ``torch.Tensor``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Analog of racc::invalidTriangle (reference RayAccelerator.h:26).
INVALID_TRIANGLE = -1


class Rays(NamedTuple):
    """A ray stream in SoA layout."""

    o: torch.Tensor      # (R, 3) float32 origin
    d: torch.Tensor      # (R, 3) float32 direction
    tmin: torch.Tensor   # (R,)  float32
    tmax: torch.Tensor   # (R,)  float32

    @property
    def count(self) -> int:
        return self.o.shape[0]


class Hits(NamedTuple):
    """Intersection results in SoA layout; ``tri == INVALID_TRIANGLE`` is a
    miss. ``u``/``v`` follow the Embree convention over the original vertex
    order, as in ``rayaccel_tpu/types.py``."""

    tri: torch.Tensor       # (R,) int32
    t: torch.Tensor         # (R,) float32
    u: torch.Tensor         # (R,) float32
    v: torch.Tensor         # (R,) float32
    miss_rgb: torch.Tensor  # (R, 3) float32


class Stats(NamedTuple):
    """Render statistics: rays dispatched to an intersection test."""

    rays_traced: torch.Tensor  # () integer counter


def make_rays(o, d, tmin=1e-3, tmax=1e6) -> Rays:
    """Build a ray stream on ``o``'s device, broadcasting scalar tmin/tmax."""
    o = torch.as_tensor(o, dtype=torch.float32)
    d = torch.as_tensor(d, dtype=torch.float32, device=o.device)
    n = o.shape[0]
    tmin = torch.as_tensor(tmin, dtype=torch.float32,
                           device=o.device).expand(n).contiguous()
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=o.device).expand(n).contiguous()
    return Rays(o, d, tmin, tmax)
