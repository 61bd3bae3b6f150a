"""Threefry-2x32 random streams, bit-exact with ``jax.random``.

Counterpart of the ``jax.random`` calls on the headline path
(``PRNGKey``, ``fold_in``, ``uniform``), of ``split`` and ``normal`` (the
oracle's scattered rays and the dry run's per-rank keys) and of
``rayaccel_tpu/render/pathtracer.py:_lane_uniform``. A key is a tuple of
two Python ints (the two uint32 words of a raw jax key), so folding a
scalar into a key is host arithmetic; the per-element streams run as int64
tensor arithmetic on the device of the tensor they are given; the tensor
draws (``uniform``, ``lane_uniform``) run inside the span
``racc.shade.rng`` (``utils/spans.py``).

Matching jax (0.9, ``jax_threefry_partitionable=True``):

- ``uniform`` hashes a 64-bit iota split into (hi, lo) words and uses
  ``bits1 ^ bits2`` (``jax/_src/prng.py:_threefry_random_bits_partitionable``);
- ``split`` hashes the same iota into whole keys
  (``_threefry_split_foldlike``), so its i-th key is ``fold_in(key, i)``;
- ``normal`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  (-1, 1), and ``erf_inv`` is XLA's single-precision polynomial (M. Giles,
  "Approximating the erfinv function"), which ``torch.special.erfinv``
  does not round alike;
- ``lane_uniform`` calls the raw ``threefry_2x32``, which splits its counter
  array in half and pairs element i with element n/2 + i.

CPU torch has no uint32 shifts, adds or compares, so every word is held in
an int64 and masked to 32 bits after each operation. The same code runs on
Python ints (keys) and on int64 tensors (streams).
"""

from __future__ import annotations

from typing import Tuple

import torch

from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.utils.spans import span

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 words held in
    Python ints or int64 tensors. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    return (0, int(seed) & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash the counter pair (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def split(key: Key, n: int = 2) -> list:
    """``jax.random.split(key, n)``: n keys, bitwise equal to JAX's."""
    return [fold_in(key, i) for i in range(n)]


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> float32 in [0, 1): 23 random mantissa
    bits under exponent 0, minus one (jax.random.uniform's construction)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def fold_in_each(key: Key, data: torch.Tensor):
    """``vmap(lambda p: fold_in(key, p))(data)``: one key per element of an
    integer tensor (each taken mod 2^32). Returns the two key words as
    int64 tensors of ``data``'s shape."""
    x1 = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(x1), x1)


def uniform_pair_each(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """``vmap(lambda k: uniform(k, (2,)))`` over per-element keys (the word
    tensors :func:`fold_in_each` returns): (..., 2) float32. Each key
    hashes the counters (0, 0) and (0, 1), as :func:`uniform` does for a
    shape of two elements."""
    draws = []
    for lo in (0, 1):
        b0, b1 = threefry2x32(k0, k1, torch.zeros_like(k0),
                              torch.full_like(k0, lo))
        draws.append(b0 ^ b1)
    return _bits_to_unit_float(torch.stack(draws, dim=-1))


def uniform(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on ``device`` (default:
    the current CUDA device; with none visible this raises, as
    :func:`device.resolve_device` does)."""
    device = resolve_device(device)
    n = 1
    for s in shape:
        n *= int(s)
    with span("racc.shade.rng"):
        lo = torch.arange(n, dtype=torch.int64, device=device)
        b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
        return _bits_to_unit_float(b0 ^ b1).reshape(tuple(shape))


def lane_uniform(key: Key, lane: torch.Tensor) -> torch.Tensor:
    """Per-lane (R, 3) uniforms keyed by lane id (``_lane_uniform``).

    The JAX function hashes the counter array [l, l+2^30, l+2^31, l+3*2^30]
    with ``threefry_2x32``, which pairs (l, l+2^31) and (l+2^30,
    l+3*2^30) into one cipher block each; its three draws are the first
    word of each block and the second word of the first block."""
    with span("racc.shade.rng"):
        l = lane.to(torch.int64)
        a0, a1 = threefry2x32(key[0], key[1], l, (l + (2 << 30)) & _M32)
        b0, _ = threefry2x32(key[0], key[1], (l + (1 << 30)) & _M32,
                             (l + (3 << 30)) & _M32)
        return _bits_to_unit_float(torch.stack([a0, b0, a1], dim=1))


# XLA's erf_inv for float32 (``ErfInv32``): a degree-8 polynomial in
# w - 2.5 below w = 5 and in sqrt(w) - 3 above, with w = -log1p(-x^2).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# The lower end of normal's uniform draw: the float32 after -1 toward 0.
_NORMAL_LO = -1.0 + 2.0 ** -24


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on a float32 tensor in (-1, 1)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return p * x


def normal(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device`` (as for
    :func:`uniform`), to a few float32 ulps (``erf_inv``'s ``log1p``
    rounds as the device's does)."""
    # uniform(key, shape, minval=lo, maxval=1): (1 - lo) rounds to 2 in
    # float32, so f * 2 + lo is one rounding, as in JAX.
    u = torch.clamp_min(uniform(key, shape, device) * 2.0 + _NORMAL_LO,
                        _NORMAL_LO)
    return erf_inv(u) * torch.tensor(2.0 ** 0.5, dtype=torch.float32,
                                     device=u.device)
