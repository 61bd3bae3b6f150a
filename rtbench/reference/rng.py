"""Threefry-2x32, as ``jax.random`` draws it: a frozen copy of the streams
the renderers use (the cipher that ``fold_in`` hashes keys with, ``uniform`` at
given positions, and the per-lane draws of the pooled bounces).

A key is a pair of Python ints (two uint32 words). Words are held in int64
tensors and masked to 32 bits after each operation, so the same code runs
on Python ints and on tensors of either device.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """20 rounds of Threefry-2x32 on the words (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1): 23 mantissa bits under exponent
    0, minus one."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform_at(key, index: torch.Tensor) -> torch.Tensor:
    """The elements at flat positions ``index`` of
    ``jax.random.uniform(key, shape)``: element i hashes the counter pair
    (0, i)."""
    i = index.to(torch.int64)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return _unit_float(b0 ^ b1)


def lane_uniform(key, lane: torch.Tensor) -> torch.Tensor:
    """(n, 3) draws keyed by lane id: the raw cipher on the counter array
    [l, l + 2^30, l + 2^31, l + 3 * 2^30], which pairs (l, l + 2^31) and
    (l + 2^30, l + 3 * 2^30); the draws are the first word of each block
    and the second word of the first."""
    lane = lane.to(torch.int64)
    a0, a1 = threefry2x32(key[0], key[1], lane, (lane + (2 << 30)) & M32)
    b0, _ = threefry2x32(key[0], key[1], (lane + (1 << 30)) & M32,
                         (lane + (3 << 30)) & M32)
    return _unit_float(torch.stack([a0, b0, a1], dim=1))
