"""The port's threefry streams against jax.random, bitwise: PRNGKey,
fold_in, uniform (partitionable threefry), the path tracer's lane-keyed
draws and the stratified sampler's per-pixel pair, over the keys, lane ids
and pixels of tests/rng_cases.py (which the card tests of the kernel
share). On the CPU each draw runs its plain int64 path."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayaccel_tpu.render.pathtracer import _lane_uniform

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.ops import _kernels
from rng_cases import EDGE_LANES, EDGE_PIXELS, KEYS, key, pixel_ids

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 0x5EED, 2 ** 31 - 1]


def _key_words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def _jax_key(spec):
    k = jax.random.PRNGKey(spec[0])
    for data in spec[1:]:
        k = jax.random.fold_in(k, np.uint32(data))
    return k


def _same_bits(got, ref):
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in(seed):
    ref = jax.random.PRNGKey(seed)
    key = rng.PRNGKey(seed)
    assert key == _key_words(ref)
    for data in (0, 1, 4096, 4097, 2 ** 31 + 5):
        ref2 = jax.random.fold_in(ref, np.uint32(data))
        assert rng.fold_in(key, data) == _key_words(ref2), data
    # A two-level chain, as the frame's stage-1 keys are built.
    assert (rng.fold_in(rng.fold_in(key, 3), 1)
            == _key_words(jax.random.fold_in(jax.random.fold_in(ref, 3), 1)))


@pytest.mark.parametrize("spec", KEYS)
def test_keys_are_jax_keys(spec):
    assert key(spec) == _key_words(_jax_key(spec))


@pytest.mark.parametrize("spec", KEYS)
@pytest.mark.parametrize("shape", [(5,), (2, 1000), (4096, 3), (3, 7, 11),
                                   (0,)])
def test_uniform_bitwise(shape, spec):
    ref = jax.random.uniform(_jax_key(spec), shape, jnp.float32)
    got = rng.uniform(key(spec), shape, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    _same_bits(got, ref)


@pytest.mark.parametrize("spec", KEYS)
def test_lane_uniform_bitwise(spec):
    lanes = np.concatenate([np.arange(1000), EDGE_LANES, [123456, 0, 5]])
    ref = _lane_uniform(_jax_key(spec), jnp.asarray(lanes, jnp.int32))
    got = rng.lane_uniform(key(spec), torch.as_tensor(lanes,
                                                      dtype=torch.int32))
    assert tuple(got.shape) == (len(lanes), 3)
    _same_bits(got, ref)
    # Keyed by lane id, not position: a permutation permutes the rows.
    perm = np.random.default_rng(0).permutation(len(lanes))
    shuffled = rng.lane_uniform(key(spec), torch.as_tensor(
        lanes[perm], dtype=torch.int32))
    np.testing.assert_array_equal(shuffled.numpy(), got.numpy()[perm])


@pytest.mark.parametrize("spec", KEYS)
def test_fold_in_uniform_pair_bitwise(spec):
    """The stratified sampler's rotation: ``vmap`` of ``fold_in`` then
    ``uniform(k, (2,))`` over the pixels' packed ids."""
    rs = np.random.default_rng(spec[0] & 0xFFFF)
    xs = np.concatenate([[x for x, _ in EDGE_PIXELS],
                         rs.integers(0, 1280, 2048)])
    ys = np.concatenate([[y for _, y in EDGE_PIXELS],
                         rs.integers(0, 720, 2048)])
    pix = np.asarray(pixel_ids(xs, ys))
    ref = jax.vmap(lambda p: jax.random.uniform(
        jax.random.fold_in(_jax_key(spec), p), (2,), jnp.float32))(
            jnp.asarray(pix, jnp.int32))
    got = rng.fold_in_uniform_pair(key(spec), torch.as_tensor(pix))
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(pix), 2)
    _same_bits(got, ref)
    # A 2-D tensor of pixel ids gives its shape and a row pair each.
    got2 = rng.fold_in_uniform_pair(key(spec),
                                    torch.as_tensor(pix[:2048]).reshape(64, 32))
    np.testing.assert_array_equal(got2.reshape(-1, 2).numpy(),
                                  got[:2048].numpy())


def test_cpu_draws_never_reach_the_kernel(monkeypatch):
    """On CPU tensors the draws run their plain int64 paths: the kernel
    library is never asked for and no launch is counted."""
    def no_library():
        raise AssertionError("a CPU draw asked for the kernel library")
    monkeypatch.setattr(_kernels, "library", no_library)
    launches = rng.threefry_draws.launches
    k = key(KEYS[3])
    lanes = torch.as_tensor(EDGE_LANES, dtype=torch.int32)
    pix = torch.as_tensor(pixel_ids(*zip(*EDGE_PIXELS)))
    _same_bits(rng.uniform(k, (2, 7), device="cpu"),
               rng.uniform_plain(k, (2, 7), "cpu").numpy())
    _same_bits(rng.lane_uniform(k, lanes),
               rng.lane_uniform_plain(k, lanes).numpy())
    _same_bits(rng.fold_in_uniform_pair(k, pix),
               rng.fold_in_uniform_pair_plain(k, pix).numpy())
    rng.normal(k, (4,), device="cpu")
    assert rng.threefry_draws.launches == launches


def test_kernel_draws_refuse_more_rows_than_it_indexes():
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        rng.threefry_draws(rng._POSITIONAL, key(KEYS[0]), None, 2 ** 31,
                           "cpu")
