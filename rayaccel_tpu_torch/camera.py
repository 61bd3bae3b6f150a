"""Pinhole camera and primary-ray generation.

Counterpart of ``rayaccel_tpu/camera.py`` (``:30-138``): ``Camera`` is the
same NumPy object (``look_at``, ``rotate`` and ``forward`` are the same host
arithmetic), and :func:`generate_pixel_rays` builds the same jittered
rays with torch on the device of the pixel coordinates:

    dir(px, py) = normalize(view + right * px + up * py)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.ops.intersect import dot3
from rayaccel_tpu_torch.types import Rays


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


@dataclasses.dataclass
class Camera:
    """Camera with baked per-pixel deltas."""

    origin: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    view: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, 0, 1], np.float32))
    right: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))

    @staticmethod
    def look_at(origin, target, up, fov_deg, width, height) -> "Camera":
        origin = np.asarray(origin, np.float32)
        target = np.asarray(target, np.float32)
        up = np.asarray(up, np.float32)

        forward = _normalize(target - origin)
        right = _normalize(np.cross(forward, up))
        camera_up = np.cross(right, forward)

        aspect = float(width) / float(height)
        extent_x = math.tan(0.5 * fov_deg * (math.pi / 180.0)) * aspect
        extent_y = math.tan(0.5 * fov_deg * (math.pi / 180.0))

        return Camera(
            origin=origin,
            right=(right * (-2.0 / width * extent_x)).astype(np.float32),
            up=(camera_up * (-2.0 / height * extent_y)).astype(np.float32),
            view=(forward + right * extent_x + camera_up * extent_y).astype(np.float32),
        )

    def rotate(self, angle: float, axis, pivot=None) -> "Camera":
        """Rotate by ``angle`` radians about ``axis`` through ``pivot``
        (default: the origin of the camera); the host arithmetic of
        ``rayaccel_tpu/camera.py:Camera.rotate``."""
        axis = _normalize(np.asarray(axis, np.float64))
        c, s = math.cos(angle), math.sin(angle)
        x, y, z = axis
        rot = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ])
        pivot = self.origin if pivot is None else np.asarray(pivot, np.float32)
        origin = (rot @ (self.origin - pivot)) + pivot
        return Camera(
            origin=origin.astype(np.float32),
            view=(rot @ self.view).astype(np.float32),
            right=(rot @ self.right).astype(np.float32),
            up=(rot @ self.up).astype(np.float32),
        )

    def forward(self) -> np.ndarray:
        """The view direction with its right and up components removed,
        normalized (``rayaccel_tpu/camera.py:Camera.forward``)."""
        n = _normalize(self.right)
        t = _normalize(self.up)
        fwd = self.view - n * np.dot(self.view, n)
        fwd = fwd - t * np.dot(fwd, t)
        return _normalize(fwd)

    def as_arrays(self, device=None):
        """(origin, view, right, up) as float32 tensors on ``device``
        (default: the current CUDA device; with none visible this raises,
        as :func:`device.resolve_device` does)."""
        device = resolve_device(device)
        return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                     for a in (self.origin, self.view, self.right, self.up))


def generate_pixel_rays(cam_arrays, px: torch.Tensor, py: torch.Tensor,
                        key=None, tmin: float = 0.0, tmax: float = 1e6,
                        jitter=None) -> Rays:
    """Jittered primary rays for a batch of pixel coordinates.

    ``key`` (an :mod:`rng` key) draws the jitter as
    ``jax.random.uniform(key, (2, R))`` does; without key or jitter the
    rays pass through pixel centres."""
    origin, view, right, up = cam_arrays
    px = px.to(torch.float32)
    py = py.to(torch.float32)
    if jitter is not None:
        px = px + jitter[0]
        py = py + jitter[1]
    elif key is not None:
        jit = rng.uniform(key, (2, px.shape[0]), device=px.device)
        px = px + jit[0]
        py = py + jit[1]
    else:
        px = px + 0.5
        py = py + 0.5

    d = view[None, :] + right[None, :] * px[:, None] + up[None, :] * py[:, None]
    d = d * torch.rsqrt(dot3(d, d))[:, None]
    n = px.shape[0]
    return Rays(
        o=origin[None, :].expand(n, 3).contiguous(), d=d,
        tmin=torch.full((n,), tmin, dtype=torch.float32, device=px.device),
        tmax=torch.full((n,), tmax, dtype=torch.float32, device=px.device),
    )
