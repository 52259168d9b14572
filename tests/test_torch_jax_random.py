"""The port's copy of JAX's default PRNG (`ops/jax_random.py`) against
jax.random itself, and `pointcloud.ransac_plane` against the JAX package's
at the same seed.

Tolerances: keys and draws bit-equal; RANSAC's inlier count and mask
equal, its plane coefficients within atol 1e-6 (the normal's float32
arithmetic in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evflow_tpu.models import pointcloud as jpc
from evflow_tpu_torch.models import pointcloud
from evflow_tpu_torch.ops import jax_random

SEEDS = [0, 1, 42, 2**31 - 1]
# 3 * 2^16 + 5 is no power of two, and above 2^16, where randint's
# uint32 multiplier wraps
SPANS = [1, 7, 100, 2**17, 3 * 2**16 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jax_random.prng_key(seed), np.asarray(key))
    for num in (2, 3):
        np.testing.assert_array_equal(jax_random.split(jax_random.prng_key(seed), num),
                                      np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("n", SPANS)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equals_jax(seed, n):
    got = jax_random.randint(jax_random.prng_key(seed), (100, 3), 0, n)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (100, 3), 0, n))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _plane_scene(seed, n=600):
    rng = np.random.default_rng(seed)
    m = 3 * n // 4
    plane = np.stack([rng.uniform(0, 1, m), rng.uniform(0, 1, m),
                      0.3 + rng.normal(0, 0.005, m)], 1)
    blob = rng.normal((0.5, 0.5, 0.8), 0.05, (n - m, 3))
    return np.concatenate([plane, blob]).astype(np.float32)


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_ransac_plane_equals_jax(seed, with_valid):
    """App C's plane fit end to end at the same seed: the same hypotheses,
    so the same inliers and plane."""
    pts = _plane_scene(seed % 97)
    n = len(pts)
    valid = np.random.default_rng(12).random(n) < 0.9 if with_valid else np.ones(n, bool)
    got = pointcloud.ransac_plane(torch.as_tensor(pts), torch.as_tensor(valid),
                                  threshold=0.02, iters=100, seed=seed)
    want = jpc.ransac_plane(jnp.asarray(pts), jnp.asarray(valid), threshold=0.02,
                            iters=100, seed=seed)
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), rtol=0, atol=1e-6)
