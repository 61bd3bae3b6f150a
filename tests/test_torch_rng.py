"""The port's threefry streams against jax.random, bitwise: PRNGKey,
fold_in, uniform (partitionable threefry) and the path tracer's lane-keyed
draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayaccel_tpu.render.pathtracer import _lane_uniform

from rayaccel_tpu_torch import rng

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 0x5EED, 2 ** 31 - 1]


def _key_words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


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


@pytest.mark.parametrize("shape", [(5,), (2, 1000), (4096, 3), (3, 7, 11)])
def test_uniform_bitwise(shape):
    key = rng.fold_in(rng.PRNGKey(11), 2)
    ref = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(11), 2),
                             shape, jnp.float32)
    got = rng.uniform(key, shape, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


def test_lane_uniform_bitwise():
    lanes = np.concatenate([np.arange(1000), [2 ** 24 - 1, 123456, 0, 5]])
    for seed, b in ((5, 0), (9, 1)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 4096 + b)
        key = rng.fold_in(rng.PRNGKey(seed), 4096 + b)
        ref = _lane_uniform(jkey, jnp.asarray(lanes, jnp.int32))
        got = rng.lane_uniform(key, torch.as_tensor(lanes, dtype=torch.int32))
        assert tuple(got.shape) == (len(lanes), 3)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(ref).view(np.uint32))
    # Keyed by lane id, not position: a permutation permutes the rows.
    perm = np.random.default_rng(0).permutation(len(lanes))
    shuffled = rng.lane_uniform(key, torch.as_tensor(lanes[perm],
                                                     dtype=torch.int32))
    np.testing.assert_array_equal(shuffled.numpy(), got.numpy()[perm])
