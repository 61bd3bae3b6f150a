"""Threefry-2x32 random streams, bit-exact with ``jax.random``.

Counterpart of the ``jax.random`` calls on the headline path
(``PRNGKey``, ``fold_in``, ``uniform``), of ``split`` and ``normal`` (the
oracle's scattered rays and the dry run's per-rank keys) and of
``rayaccel_tpu/render/pathtracer.py:_lane_uniform``. A key is a tuple of
two Python ints (the two uint32 words of a raw jax key), so folding a
scalar into a key is host arithmetic. The tensor draws (``uniform``,
``lane_uniform``, ``fold_in_uniform_pair``) run inside the span
``racc.shade.rng`` (``utils/spans.py``): on a CPU tensor as int64 tensor
arithmetic (their ``_plain`` twins, which run on any device), on a CUDA
tensor as one launch of ``csrc/threefry.cu`` with the same bits.

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

CPU torch has no uint32 shifts, adds or compares, so every word of the plain
path is held in an int64 and masked to 32 bits after each operation. The
same code runs on Python ints (keys) and on int64 tensors (streams).
"""

from __future__ import annotations

from typing import Tuple

import torch

from rayaccel_tpu_torch.device import resolve_device
from rayaccel_tpu_torch.ops import _kernels
from rayaccel_tpu_torch.utils.spans import span

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# The draw shapes of ``csrc/threefry.cu`` (its template parameter), and the
# floats of an output row of each.
_POSITIONAL, _LANE, _PAIR = 0, 1, 2
_ROW = {_POSITIONAL: 1, _LANE: 3, _PAIR: 2}


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


def threefry_draws(shape: int, key: Key, ids, n: int,
                   device) -> torch.Tensor:
    """One launch of ``csrc/threefry.cu``: the (n, row) float32 draws of
    draw shape ``shape`` (``_POSITIONAL``, ``_LANE`` or ``_PAIR``) under
    ``key``, from the (n,) int32 tensor ``ids`` (lane ids or elements;
    None for positional draws) on CUDA ``device``.
    ``threefry_draws.launches`` counts its launches."""
    if n > 0x7FFFFFFF:
        raise ValueError(f"the threefry kernel draws at most 2^31 - 1 rows, "
                         f"got {n}")
    out = torch.empty((n, _ROW[shape]), dtype=torch.float32, device=device)
    if ids is not None:
        ids = ids.contiguous()
        _kernels.require(ids, "ids", torch.int32, (n,))
    if n == 0:
        return out
    _kernels.check(_kernels.library().racc_threefry(
        shape, _kernels.ptr(ids) if ids is not None else None,
        _kernels.ptr(out), n, key[0], key[1], _kernels.stream()),
        "racc_threefry")
    threefry_draws.launches += 1
    return out


threefry_draws.launches = 0


def fold_in_uniform_pair(key: Key, data: torch.Tensor) -> torch.Tensor:
    """``vmap(lambda p: uniform(fold_in(key, p), (2,)))(data)`` over an
    integer tensor (each element taken mod 2^32): (..., 2) float32, the
    stratified sampler's per-pixel rotation. One kernel launch on a CUDA
    tensor, which must be int32; :func:`fold_in_uniform_pair_plain` on a
    CPU tensor."""
    with span("racc.shade.rng"):
        if data.device.type == "cpu":
            return fold_in_uniform_pair_plain(key, data)
        return threefry_draws(_PAIR, key, data.reshape(-1), data.numel(),
                              data.device).reshape(*data.shape, 2)


def fold_in_uniform_pair_plain(key: Key, data: torch.Tensor) -> torch.Tensor:
    """:func:`fold_in_uniform_pair` as int64 tensor arithmetic, on any
    device: :func:`fold_in_each`, then :func:`uniform_pair_each`."""
    return uniform_pair_each(*fold_in_each(key, data))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def uniform(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on ``device`` (default:
    the current CUDA device; with none visible this raises, as
    :func:`device.resolve_device` does). One kernel launch on a CUDA
    device; :func:`uniform_plain` on the CPU."""
    device = resolve_device(device)
    with span("racc.shade.rng"):
        if device.type == "cpu":
            return uniform_plain(key, shape, device)
        return threefry_draws(_POSITIONAL, key, None, _numel(shape),
                              device).reshape(tuple(shape))


def uniform_plain(key: Key, shape, device) -> torch.Tensor:
    """:func:`uniform` as int64 tensor arithmetic, on any ``device``: the
    64-bit iota's (hi, lo) = (0, i) hashed, ``bits1 ^ bits2``."""
    lo = torch.arange(_numel(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return _bits_to_unit_float(b0 ^ b1).reshape(tuple(shape))


def lane_uniform(key: Key, lane: torch.Tensor) -> torch.Tensor:
    """Per-lane (R, 3) uniforms keyed by the (R,) lane ids ``lane``
    (``_lane_uniform``): one kernel launch on a CUDA tensor, which must be
    int32; :func:`lane_uniform_plain` on a CPU tensor."""
    with span("racc.shade.rng"):
        if lane.device.type == "cpu":
            return lane_uniform_plain(key, lane)
        return threefry_draws(_LANE, key, lane, lane.shape[0], lane.device)


def lane_uniform_plain(key: Key, lane: torch.Tensor) -> torch.Tensor:
    """:func:`lane_uniform` as int64 tensor arithmetic, on any device.

    The JAX function hashes the counter array [l, l+2^30, l+2^31, l+3*2^30]
    with ``threefry_2x32``, which pairs (l, l+2^31) and (l+2^30,
    l+3*2^30) into one cipher block each; its three draws are the first
    word of each block and the second word of the first block."""
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
