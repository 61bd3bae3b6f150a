"""Materials: the parameter table and the vectorized reflective-diffuse BSDF.

Counterpart of ``rayaccel_tpu/materials.py``: the table API
(``MaterialTable``, ``reflective_diffuse``, ``make_material_table``,
``default_materials``, ``:28-56``) and ``sample_reflective_diffuse`` with
``_orthonormal_basis`` (``:58-137``): a Fresnel-weighted mirror lobe plus a
cosine-hemisphere diffuse lobe, picked by relative weight, over per-ray
parameters [kr, kg, kb, eta].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from rayaccel_tpu_torch.ops.intersect import dot3


class MaterialTable(NamedTuple):
    """Parameter table: one row per material, ``params[:, 0:3]`` the albedo
    k (rgb) and ``params[:, 3]`` eta."""

    params: torch.Tensor  # (M, 4) float32


def reflective_diffuse(k, eta: float) -> np.ndarray:
    """One table row [kr, kg, kb, eta]; a scalar ``k`` is grey."""
    k = np.broadcast_to(np.asarray(k, np.float32), (3,))
    return np.array([k[0], k[1], k[2], eta], np.float32)


def make_material_table(rows) -> MaterialTable:
    return MaterialTable(params=torch.tensor(np.stack(rows),
                                             dtype=torch.float32))


def default_materials() -> MaterialTable:
    """The four demo materials (reference main.cpp:163-168)."""
    return make_material_table([
        reflective_diffuse(0.8, 1.0 / 1.4),
        reflective_diffuse(0.1, 1.0 / 1.4),
        reflective_diffuse(0.6, 1.0 / 1.2),
        reflective_diffuse(0.3, 1.0 / 1.2),
    ])


def _orthonormal_basis(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tangent frame: base_u from whichever of x / z dominates, then
    v = n x u."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    zero = torch.zeros_like(nx)
    base_mask = torch.abs(nx) > 0.1
    ux = torch.where(base_mask, -nz, zero)
    uy = torch.where(base_mask, zero, -nz)
    uz = torch.where(base_mask, nx, ny)
    inv = torch.rsqrt(ux * ux + uy * uy + uz * uz)
    ux, uy, uz = ux * inv, uy * inv, uz * inv
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    return torch.stack([ux, uy, uz], dim=-1), torch.stack([vx, vy, vz], dim=-1)


def sample_reflective_diffuse(params: torch.Tensor, rnd: torch.Tensor,
                              normal: torch.Tensor, wo: torch.Tensor):
    """Sample the BSDF.

    Args:
      params: (R, 4) per-ray [kr, kg, kb, eta].
      rnd:    (R, 3) uniforms in [0, 1).
      normal: (R, 3) shading normal, flipped toward the incoming ray.
      wo:     (R, 3) outgoing direction = -ray_dir.

    Returns (wi, color, transmitted), as the JAX function does. sin and cos
    run in float64 and round once to float32, so a value does not depend on
    where it sits in the batch.
    """
    k = params[:, 0:3]
    eta = params[:, 3]

    cosi = torch.clamp_min(dot3(normal, wo), 0.0)
    refl = 2.0 * cosi[:, None] * normal - wo

    kk = eta * eta * (cosi * cosi - 1.0) + 1.0          # < 0 => TIR
    cost = torch.sqrt(torch.clamp_min(kk, 0.0))
    rper = (eta * cosi - cost) / (eta * cosi + cost)
    rpar = -((eta * cost - cosi) / (eta * cost + cosi))
    fresnel = 0.5 * (rpar * rpar + rper * rper)
    fresnel = torch.where(kk < 0.0, torch.ones_like(fresnel), fresnel)

    u, v = _orthonormal_basis(normal)
    phi = (2.0 * math.pi) * rnd[:, 0]
    sin_x = torch.sin(phi.double()).float()
    cos_x = torch.cos(phi.double()).float()
    r2 = rnd[:, 1]
    r2s = torch.sqrt(r2)
    diff = (normal * torch.sqrt(1.0 - r2)[:, None]
            + (u * cos_x[:, None] + v * sin_x[:, None]) * r2s[:, None])
    diff = diff * torch.rsqrt(dot3(diff, diff))[:, None]

    s0 = fresnel * 3.0
    s1 = k[:, 0] + k[:, 1] + k[:, 2]
    total = s0 + s1
    pick_diffuse = rnd[:, 2] * total >= s0

    wi = torch.where(pick_diffuse[:, None], diff, refl)
    color = torch.where(pick_diffuse[:, None], k, fresnel[:, None])
    scale = total / (color[:, 0] + color[:, 1] + color[:, 2])
    color = color * scale[:, None]

    transmitted = torch.zeros(params.shape[0], dtype=torch.bool,
                              device=params.device)
    return wi, color, transmitted
