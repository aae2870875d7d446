"""The port's threefry2x32 against ``jax.random``: keys and random bits
bitwise, gumbel noise within 1e-6 (``log`` may differ by an ulp)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu_torch.inference import prng


def bits(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_jax_layout_flags_the_port_follows():
    # split/random_bits lay out their counters by this flag; a JAX that
    # changes it must fail here rather than silently diverge
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_high_dynamic_range_gumbel


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -7])
def test_prng_key_and_key_data(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  bits(jax.random.PRNGKey(seed)))
    ref = jax.random.key_data(jax.random.key(seed, impl="threefry2x32"))
    got = prng.key_data(prng.key(seed, impl="threefry2x32"))
    np.testing.assert_array_equal(got.numpy(), bits(ref))
    np.testing.assert_array_equal(
        prng.wrap_key_data(got, impl="threefry2x32").numpy(), bits(ref))


@pytest.mark.parametrize("n", [2, 17])
def test_split(n):
    for seed in (0, 11):
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(seed), n).numpy(),
            bits(jax.random.split(jax.random.PRNGKey(seed), n)))


def test_fold_in_scalar_and_per_row():
    k = jax.random.PRNGKey(5)
    for data in (0, 1, 123456, 2**31 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(prng.PRNGKey(5), data).numpy(),
            bits(jax.random.fold_in(k, data)))
    keys = jax.random.split(k, 6)
    ctr = np.array([0, 3, 9, 100, 4097, 65536], np.int32)
    want = jax.vmap(jax.random.fold_in)(keys, ctr)
    got = prng.fold_in(torch.from_numpy(bits(keys)), torch.from_numpy(ctr))
    np.testing.assert_array_equal(got.numpy(), bits(want))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 300), (1, 4097)])
def test_random_bits_and_uniform(shape):
    k = jax.random.PRNGKey(9)
    np.testing.assert_array_equal(
        prng.random_bits(prng.PRNGKey(9), shape).numpy(),
        bits(jax.random.bits(k, shape, jnp.uint32)))
    np.testing.assert_array_equal(
        prng.uniform(prng.PRNGKey(9), shape).numpy(),
        np.asarray(jax.random.uniform(k, shape, jnp.float32)))


def test_gumbel_whole_batch_and_per_row():
    k = jax.random.PRNGKey(3)
    np.testing.assert_allclose(
        prng.gumbel(prng.PRNGKey(3), (4, 500)).numpy(),
        np.asarray(jax.random.gumbel(k, (4, 500), jnp.float32)),
        atol=1e-6, rtol=0)
    # one key per row, noise over [V] (the slot path's vmapped draw)
    keys = jax.random.split(k, 3)
    ctr = np.array([5, 6, 70], np.int32)
    folded = jax.vmap(jax.random.fold_in)(keys, ctr)
    want = jax.vmap(lambda kk: jax.random.gumbel(kk, (257,), jnp.float32))(
        folded)
    got = prng.gumbel(prng.fold_in(torch.from_numpy(bits(keys)),
                                   torch.from_numpy(ctr)), (257,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
