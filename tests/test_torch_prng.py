"""repro_torch.prng against jax.random: key words, bits, uniform floats and
randint exact; Gumbel floats within 1 ulp.

Pinned to ``jax_threefry_partitionable=True`` (the default of the jax the
tests run with); the port copies that setting's key derivation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ws_step.kernel import (
    gumbel_from_bits as jax_gumbel_from_bits,
    threefry2x32 as jax_threefry2x32,
    threefry_gumbel as jax_threefry_gumbel,
)
from repro_torch import prng


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _within_one_ulp_of_gumbel(a, b):
    """|a - b| <= 1 ulp of max(|a|, 1). Gumbel is -log(-log u): where g is
    near 0 the inner log is near 1, and its (allowed) 1-ulp difference
    between two log implementations is an absolute ~1e-7 there."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return bool(np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a), np.float32(1)))))


def test_threefry_words_exact():
    rng = np.random.default_rng(0)
    k0, k1, c0, c1 = (rng.integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
                      for _ in range(4))
    jx0, jx1 = jax_threefry2x32(*(jnp.asarray(a) for a in (k0, k1, c0, c1)))
    tx0, tx1 = prng.threefry2x32(*(torch.from_numpy(a.astype(np.int64)) for a in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(np.asarray(jx0).astype(np.int64), tx0.numpy())
    np.testing.assert_array_equal(np.asarray(jx1).astype(np.int64), tx1.numpy())


@pytest.mark.parametrize("seed", [0, 1, 11, 2**31 - 1, -1, -12345])
def test_key_exact(seed):
    np.testing.assert_array_equal(_kd(jax.random.key(seed)), prng.key(seed).numpy())


def test_key_rejects_out_of_int32_seed():
    with pytest.raises(ValueError):
        prng.key(2**31)


@pytest.mark.parametrize("seed,num", [(0, 2), (7, 13), (-3, 1)])
def test_split_exact(seed, num):
    kj, kt = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_kd(jax.random.split(kj, num)), prng.split(kt, num).numpy())
    # nested: split of a split key (refine_loop_inputs after serve's split)
    sj = jax.random.split(jax.random.split(kj)[1], num)
    st = prng.split(prng.split(kt)[1], num)
    np.testing.assert_array_equal(_kd(sj), st.numpy())


@pytest.mark.parametrize("data", [0, 1, 5, 2**31 - 1, 2**32 - 1])
def test_fold_in_exact(data):
    kj, kt = jax.random.key(42), prng.key(42)
    np.testing.assert_array_equal(_kd(jax.random.fold_in(kj, np.uint32(data))),
                                  prng.fold_in(kt, data).numpy())


def test_fold_in_batched_like_vmap():
    keys_j = jax.random.split(jax.random.key(3), 6)
    idx = np.arange(6, dtype=np.int32) * 7
    want = _kd(jax.vmap(jax.random.fold_in)(keys_j, jnp.asarray(idx)))
    got = prng.fold_in(torch.from_numpy(_kd(keys_j)), torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(want, got.numpy())


def test_key_data_identity():
    k = prng.split(prng.key(5), 4)
    assert prng.key_data(k) is k
    with pytest.raises(ValueError):
        prng.key_data(torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("shape", [(), (7,), (3, 50), (2, 4, 27)])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.0), (0.1, 0.7)])
def test_uniform_exact(shape, lo, hi):
    kj, kt = jax.random.key(9), prng.key(9)
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, shape, minval=lo, maxval=hi)),
                                  prng.uniform(kt, shape, lo, hi).numpy())


@pytest.mark.parametrize("shape", [(5,), (4, 8, 27), (64, 300)])
def test_gumbel_within_one_ulp(shape):
    kj, kt = jax.random.key(17), prng.key(17)
    g_j = np.asarray(jax.random.gumbel(kj, shape, dtype=jnp.float32))
    g_t = prng.gumbel(kt, shape).numpy()
    assert _within_one_ulp_of_gumbel(g_j, g_t)


@pytest.mark.parametrize("shape,lo,hi", [((), 0, 1000), ((40,), 0, 27), ((3, 9), -5, 70000),
                                         ((6,), 4, 4)])
def test_randint_exact(shape, lo, hi):
    kj, kt = jax.random.key(23), prng.key(23)
    np.testing.assert_array_equal(np.asarray(jax.random.randint(kj, shape, lo, hi)),
                                  prng.randint(kt, shape, lo, hi).numpy())


def test_randint_batched_keys_like_vmap():
    keys_j = jax.random.split(jax.random.key(0), 5)
    want = jax.vmap(lambda k: jax.random.randint(k, (16,), 0, 27))(keys_j)
    got = prng.randint(torch.from_numpy(_kd(keys_j)), (16,), 0, 27)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed_words", [(0, 0), (123, 456), (2**32 - 1, 2**31 + 5)])
def test_threefry_gumbel_bits_exact_and_noise_within_one_ulp(seed_words):
    rows, cols = 19, 300
    seed = jnp.asarray(np.array(seed_words, np.uint32).view(np.int32))
    r0 = jnp.arange(rows, dtype=jnp.uint32)[:, None]
    c0 = jnp.arange(cols, dtype=jnp.uint32)[None, :]
    su = seed.astype(jnp.uint32)
    bits_j, _ = jax_threefry2x32(su[0], su[1], r0, c0)
    bits_t, _ = prng.threefry2x32(seed_words[0], seed_words[1],
                                  torch.arange(rows)[:, None], torch.arange(cols)[None, :])
    np.testing.assert_array_equal(np.asarray(bits_j).astype(np.int64), bits_t.numpy())
    assert _within_one_ulp_of_gumbel(jax_gumbel_from_bits(bits_j),
                                     prng.gumbel_from_bits(bits_t).numpy())
    g_j = np.asarray(jax_threefry_gumbel(seed, rows, cols))
    g_t = prng.threefry_gumbel(seed_words, rows, cols).numpy()
    assert _within_one_ulp_of_gumbel(g_j, g_t)
