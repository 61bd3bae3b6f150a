"""The inputs of the threefry comparisons, shared by the CPU tests against
jax.random (tests/test_torch_rng.py) and the card tests of the kernel
against the plain path (tests/test_torch_cuda.py). No JAX here: the card
machine has none."""

from rayaccel_tpu_torch import rng

# Keys as (seed, data folded in, ...): raw keys, the stratified sampler's,
# and fold_in chains one and two levels deep, as the frames build them.
KEYS = [(0,), (0x5EED,), (11, 2), (5, 4097, 3), (2 ** 31 - 1, 7, 4096)]

# Lane ids at the edges of the lane-keyed counter layout (l, l + 2^30,
# l + 2^31, l + 3 * 2^30, mod 2^32), of the frame pools' 2^24 and of int32.
EDGE_LANES = [0, 1, 255, 256, 2 ** 24 - 1, 2 ** 24, 2 ** 30 - 1, 2 ** 30,
              2 ** 30 + 1, 2 ** 31 - 2, 2 ** 31 - 1]

# Pixels (x, y) of a 1280x720 frame: its corners and its middle.
EDGE_PIXELS = [(0, 0), (1279, 719), (1279, 0), (0, 719), (640, 360)]


def key(spec):
    """The port's key of a ``KEYS`` entry."""
    k = rng.PRNGKey(spec[0])
    for data in spec[1:]:
        k = rng.fold_in(k, data)
    return k


def pixel_ids(xs, ys):
    """The stratified sampler's per-pixel data, ``(y << 16) | x``, as
    ``render/pathtracer.py:_stratified_jitter`` packs it."""
    return [(int(y) << 16) | int(x) for x, y in zip(xs, ys)]
