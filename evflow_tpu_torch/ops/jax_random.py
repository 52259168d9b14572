"""JAX's default PRNG in numpy, on the host: `jax.random.PRNGKey(seed)` and
`jax.random.randint(key, shape, 0, n)` for int32 output, bit for bit, so
that a seeded draw in the port is the draw the JAX package makes.

JAX's default implementation is threefry2x32 (20 rounds of the Threefry-2x32
block cipher of Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC 2011) with `jax_threefry_partitionable` on: a key splits into keys
hash(key, (0, i)), and random bits at flat position i are the XOR of the
two words of hash(key, (0, i)). With 64-bit types off, as in the JAX
package, a seed is an int32, so the key's high word is 0.

randint maps two 32-bit draws h, l to [0, n) as
(h mod n) * (2^32 mod n) + (l mod n), mod n, with every step in uint32
and the sum wrapping at 2^32, as JAX computes it.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of the counter words (x0, x1) under the
    (2,) uint32 key: 5 groups of 4 rounds, a key injection after each."""
    ks = (np.uint32(key[0]), np.uint32(key[1]), np.uint32(key[0] ^ key[1] ^ _PARITY))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for an int32 seed: (0, seed mod 2^32)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(size: int):
    lo = np.arange(size, dtype=np.uint64)
    return (lo >> np.uint64(32)).astype(np.uint32), lo.astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: (num, 2) uint32 keys."""
    return np.stack(threefry2x32(key, *_counters(num)), axis=1)


def random_bits32(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of `shape`, in row-major order."""
    b0, b1 = threefry2x32(key, *_counters(int(np.prod(shape, dtype=np.int64))))
    return (b0 ^ b1).reshape(shape)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval)` with int32 output."""
    k_hi, k_lo = split(key)
    higher, lower = random_bits32(k_hi, shape), random_bits32(k_lo, shape)
    span = np.uint32(maxval - minval if maxval > minval else 1)
    with np.errstate(over="ignore"):
        # 2^32 mod n as JAX forms it: (2^16 mod n)^2 in uint32, which wraps
        # to 0 for n > 2^16
        multiplier = np.uint32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = (higher % span) * multiplier + lower % span
    return (np.int64(minval) + (offset % span)).astype(np.int32)
