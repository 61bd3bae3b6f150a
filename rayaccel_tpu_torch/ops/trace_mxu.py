"""Shared pieces of the cluster engines.

Counterpart of ``rayaccel_tpu/ops/trace_mxu.py``'s ``MxuHits`` and
``_ray_features`` (``:49-66``). The plain ``trace_mxu`` engine is ROADMAP
queue 1 item 12.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayaccel_tpu_torch.types import Hits

INF = 3e38   # the cull's "no overlap" entry distance


class MxuHits(NamedTuple):
    """Hits plus the hit triangle's attribute row (scene/clusters.py)."""

    hits: Hits
    attrs: torch.Tensor  # (R, ATTR_COLS)


def _ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """F = [d, o, d x o, 1, 0*6] per ray, (R, 16)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    cx = dy * oz - dz * oy
    cy = dz * ox - dx * oz
    cz = dx * oy - dy * ox
    one = torch.ones_like(dx)
    zero = torch.zeros_like(dx)
    return torch.stack([dx, dy, dz, ox, oy, oz, cx, cy, cz, one,
                        zero, zero, zero, zero, zero, zero], dim=1)
