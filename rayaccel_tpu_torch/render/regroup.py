"""Ray regrouping: restore wavefront coherence between bounces.

Counterpart of ``rayaccel_tpu/render/regroup.py``: ``coherence_key``
(15-bit origin Morton code and 3-bit direction octant, dead lanes forced
to the largest key so that live lanes compact to the front of the wave)
and ``regroup_state``, which sorts the whole lane state by that key.

The JAX function feeds XLA a multi-operand ``lax.sort`` for narrow states
and a (key, iota) sort plus row gathers for wide ones; both are stable, so
both give the permutation of one stable sort of the key. Here one path
serves both: ``torch.sort(key, stable=True)`` and a gather of every column.
"""

from __future__ import annotations

import torch

from rayaccel_tpu_torch.types import Rays

DEAD_KEY = 0x7FFFFFFF


def _spread3(v: torch.Tensor, bits: int = 5) -> torch.Tensor:
    """Interleave-ready bit spread: bit i -> bit 3i."""
    out = torch.zeros_like(v)
    for i in range(bits):
        out = out | (((v >> i) & 1) << (3 * i))
    return out


def coherence_key(rays: Rays, alive: torch.Tensor, bmin: torch.Tensor,
                  binv: torch.Tensor) -> torch.Tensor:
    """(R,) int32 sort key: 15-bit origin morton + 3-bit direction octant."""
    p = (rays.o - bmin[None, :]) * binv[None, :]
    # Convert, then clamp. The float is first held to a range every finite
    # lane's key is indifferent to (a cell index below 0 or above 31 clamps
    # the same way), so that a huge or non-finite origin converts the same
    # on every device.
    cell = torch.nan_to_num(p * 32.0, nan=0.0).clamp(-1.0, 32.0)
    q = cell.to(torch.int32).clamp(0, 31)
    morton = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
              | (_spread3(q[:, 2]) << 2))
    octant = ((rays.d[:, 0] < 0).to(torch.int32) * 4
              + (rays.d[:, 1] < 0).to(torch.int32) * 2
              + (rays.d[:, 2] < 0).to(torch.int32))
    key = (morton << 3) | octant
    return torch.where(alive, key, DEAD_KEY)


def regroup_state(key: torch.Tensor, rays: Rays, columns: list):
    """Sort lane state by ``key`` (stable). ``columns`` is a flat list of
    (R,) or (R, k) tensors. Returns (rays, columns) permuted."""
    perm = torch.sort(key, stable=True)[1]
    out_rays = Rays(rays.o[perm], rays.d[perm], rays.tmin[perm],
                    rays.tmax[perm])
    return out_rays, [c[perm] for c in columns]
