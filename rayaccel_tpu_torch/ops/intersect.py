"""Vectorized intersection primitives.

Counterpart of ``rayaccel_tpu/ops/intersect.py:safe_inv_dir`` (``:28-33``),
plus the row-wise 3-vector products every module shares. They are written
out, summed left to right, so a row rounds the same way wherever it sits
in a batch (a reduction kernel may regroup a sum by position).
"""

from __future__ import annotations

import torch

DIR_EPSILON = 1e-10  # direction component clamp, Kernels.h:149-157


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with tiny components clamped away from zero, preserving sign."""
    small = torch.abs(d) < DIR_EPSILON
    clamp = torch.where(d < 0, -DIR_EPSILON, DIR_EPSILON).to(d.dtype)
    return 1.0 / torch.where(small, clamp, d)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of (R, 3) tensors."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product of (R, 3) tensors."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)
