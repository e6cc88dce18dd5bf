"""The port's threefry2x32 stream against jax.random (partitionable mode,
the JAX 0.9 default): keys, bits, uniforms (spans that are not powers of
two too, where XLA fuses the scale and shift), bernoulli draws, randint
and permutation bit-exact, normals within a few ulp (the two erfinv
evaluations round differently)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from esn_ofdm_mimo_tpu.utils.rng import block_keys as jax_block_keys
from esn_ofdm_mimo_tpu.utils.rng import fold_key as jax_fold_key
from esn_ofdm_mimo_tpu_torch.utils import rng

# normals: the port evaluates XLA's erfinv polynomial in torch; log1p and
# fused multiply-adds round differently, measured at most 3 ulp (~5% of draws
# differ at all)
NORMAL_MAX_ULP = 4


def _keys(seed, n=16):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _ulp_dist(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5, 2**32 + 17, -5])
def test_prng_key(seed):
    np.testing.assert_array_equal(rng.prng_key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 1, 11, 2**31 + 5, 2**32 - 1])
def test_fold_in_and_fold_key(data):
    k = _keys(3)
    want = jax.vmap(lambda q: jax.random.fold_in(q, data))(k)
    np.testing.assert_array_equal(
        rng.fold_in(rng.as_keys(np.asarray(k)), data).numpy(),
        np.asarray(want))
    want2 = jax_fold_key(k[0], data, 10, 0)
    np.testing.assert_array_equal(
        rng.fold_key(rng.as_keys(np.asarray(k[0])), data, 10, 0).numpy(),
        np.asarray(want2))


@pytest.mark.parametrize("snr_idx", [0, 1, 5])
def test_block_keys(snr_idx):
    root = jax.random.PRNGKey(0)
    ids = jnp.arange(300, 300 + 37, dtype=jnp.uint32)
    want = np.asarray(jax_block_keys(root, snr_idx, ids))
    got = rng.block_keys(rng.prng_key(0), snr_idx, np.arange(300, 337))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num", [2, 5, 7])
def test_split(num):
    k = _keys(1, 4)
    want = jax.vmap(lambda q: jax.random.split(q, num))(k)
    np.testing.assert_array_equal(
        rng.split(rng.as_keys(np.asarray(k)), num).numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(1,), (9, 11), (2, 3, 5, 7)])
def test_random_bits(shape):
    k = _keys(2)
    want = np.asarray(jax.vmap(lambda q: jax.random.bits(q, shape))(k))
    got = rng.random_bits(rng.as_keys(np.asarray(k)), shape).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 0.5), (-1.0, 1.0),
                                   (-0.1, 0.1), (-np.pi, np.pi),
                                   (0.0, 2 * np.pi)])
def test_uniform(lo, hi):
    k = _keys(4)
    want = jax.vmap(lambda q: jax.random.uniform(q, (13, 6), minval=lo,
                                                 maxval=hi))(k)
    got = rng.uniform(rng.as_keys(np.asarray(k)), (13, 6), lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.5, 0.1])
def test_bernoulli(p):
    k = _keys(5)
    want = jax.vmap(lambda q: jax.random.bernoulli(q, p, (7, 64)))(k)
    got = rng.bernoulli(rng.as_keys(np.asarray(k)), p, (7, 64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 9])
def test_normal_within_ulps(seed):
    k = _keys(seed, 32)
    want = np.asarray(jax.vmap(lambda q: jax.random.normal(q, (4, 500)))(k))
    got = rng.normal(rng.as_keys(np.asarray(k)), (4, 500)).numpy()
    assert _ulp_dist(got, want).max() <= NORMAL_MAX_ULP


@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 4), (0, 16), (0, 1000),
                                   (-3, 9)])
def test_randint(lo, hi):
    k = _keys(6)
    want = jax.vmap(lambda q: jax.random.randint(q, (5, 77), lo, hi))(k)
    got = rng.randint(rng.as_keys(np.asarray(k)), (5, 77), lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [10, 1000, 200_000])
def test_permutation(n):
    """Two sort rounds at n = 200,000, with ~5 colliding 32-bit sort keys a
    round: the stable sort keeps them in JAX's order."""
    for seed in (0, 7):
        k = jax.random.PRNGKey(seed)
        got = rng.permutation(rng.as_keys(np.asarray(k)), n)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax.random.permutation(k, n)))
