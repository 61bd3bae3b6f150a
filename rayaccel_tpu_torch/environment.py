"""Angular environment probe (Debevec light probe).

Counterpart of ``rayaccel_tpu/environment.py``: ``create_environment``
(``:44-66``, the clamped 2x2 quad table) and the quad-gather branch of
``sample_environment_onehot`` (``:94-107``). The one-hot matrix branch is
a TPU device trick and is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.utils.spans import span


class Environment(NamedTuple):
    """Probe image and its (H*W, 12) table of clamped 2x2 neighbourhoods
    ([p00 p10 p01 p11] rgb per base texel), both float32 tensors."""

    pixels: torch.Tensor  # (H, W, 3)
    quad: torch.Tensor    # (H*W, 12)

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]


def create_environment(colors, width: int, height: int,
                       device=None) -> Environment:
    """``colors`` is ``(H*W, 4)`` or ``(H, W, 3/4)``; alpha is dropped.
    The tables go to ``device`` (``device.py:resolve_device``: default the
    current CUDA device)."""
    device = resolve_device(device)
    arr = np.asarray(colors, np.float32)
    if arr.ndim == 2:
        arr = arr.reshape(height, width, -1)
    arr = arr[..., :3]
    assert arr.shape[:2] == (height, width)
    h, w = height, width
    xs = np.arange(w)
    ys = np.arange(h)
    x1 = np.minimum(xs + 1, w - 1)
    y1 = np.minimum(ys + 1, h - 1)
    quad = np.concatenate([
        arr[ys[:, None], xs[None, :]],     # p00
        arr[ys[:, None], x1[None, :]],     # p10
        arr[y1[:, None], xs[None, :]],     # p01
        arr[y1[:, None], x1[None, :]],     # p11
    ], axis=-1).reshape(h * w, 12).astype(np.float32)
    return Environment(
        pixels=torch.as_tensor(np.ascontiguousarray(arr), device=device),
        quad=torch.as_tensor(quad, device=device))


def _angular_uv(env: Environment, d: torch.Tensor):
    """Direction -> probe pixel coordinates (fx, fy). ``acos`` runs in
    float64 and rounds once to float32, so a value does not depend on
    where it sits in the batch (the CPU's vector body and scalar tail
    evaluate float32 transcendentals differently)."""
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    len2 = dy * dy + dz * dz
    rlen = torch.where(len2 > 0, 1.0 / torch.sqrt(len2),
                       torch.full_like(len2, math.inf))
    acos = torch.acos(torch.clamp(-dx, -1.0, 1.0).double()).float()
    r = acos * (1.0 / (2.0 * np.pi)) * rlen
    r = torch.where(torch.isfinite(r) & (rlen <= 1e6), r, torch.zeros_like(r))
    u = 0.5 - r * dz
    v = 0.5 - r * dy
    return u * env.width - 0.5, v * env.height - 0.5


def sample_environment(env: Environment, d: torch.Tensor) -> torch.Tensor:
    """Bilinear, clamp-to-edge probe lookup for directions ``d`` (R, 3):
    one row gather from the quad table (the span ``racc.shade.env``)."""
    with span("racc.shade.env"):
        w, h = env.width, env.height
        fx, fy = _angular_uv(env, d)
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        tx = (fx - x0)[:, None]
        ty = (fy - y0)[:, None]
        x0i = torch.clamp(x0.to(torch.int32), 0, w - 1)
        y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
        q = env.quad[(y0i * w + x0i).long()]                   # (R, 12)
        top = q[:, 0:3] * (1 - tx) + q[:, 3:6] * tx
        bot = q[:, 6:9] * (1 - tx) + q[:, 9:12] * tx
        return top * (1 - ty) + bot * ty
