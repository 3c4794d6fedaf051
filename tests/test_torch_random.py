"""The port's threefry PRNG (arbius_tpu_torch/random.py) against
`jax.random` (jax 0.9.0 defaults: threefry2x32, partitionable) for the
keys the SD-1.5 bucket draws: raw bits, `fold_in` and `split` exactly;
`normal` within rtol 2e-5 / atol 1e-6, because torch's erfinv and XLA's
erf_inv differ by a few ULPs (most in the tails, where erfinv is steep)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu_torch import random as trandom

SEEDS = [0, 1, 2**32 - 1, 2**40 + 3, 0x1FFFFFFFFFFFEF]


def _keys(seed):
    lo, hi = seed & 0xFFFFFFFF, seed >> 32
    jkey = jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(lo)),
                              jnp.uint32(hi))
    tkey = trandom.fold_in(trandom.prng_key(lo, "cpu"), hi)
    return jkey, tkey


def test_jax_defaults_are_the_ported_ones():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_task_key_exact(seed):
    jkey, tkey = _keys(seed)
    np.testing.assert_array_equal(np.asarray(jkey).astype(np.int64),
                                  tkey.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(8, 8, 4), (64, 64, 4)])
def test_bits_and_step_fold_in_exact(seed, shape):
    jkey, tkey = _keys(seed)
    for step in (0, 19):   # the ancestral noise key of each step
        jk, tk = jax.random.fold_in(jkey, step), trandom.fold_in(tkey, step)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        np.testing.assert_array_equal(want.astype(np.int64),
                                      trandom.random_bits(tk, shape).numpy())


@pytest.mark.parametrize("num", [2, 3])
def test_split_exact(num):
    jkey, tkey = _keys(2**40 + 3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(jkey, num)).astype(np.int64),
        trandom.split(tkey, num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(8, 8, 4), (64, 64, 4)])
def test_normal_close(seed, shape):
    jkey, tkey = _keys(seed)
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    got = trandom.normal(tkey, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_batched_keys_match_vmap():
    """The bucket draws one key per task (the reference's vmap)."""
    seeds = np.array([1, 2**40 + 3, 7], np.uint64)
    lo = (seeds & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (seeds >> np.uint64(32)).astype(np.uint32)
    jkeys = jax.vmap(lambda a, b: jax.random.fold_in(
        jax.random.PRNGKey(a), b))(jnp.asarray(lo), jnp.asarray(hi))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, 3), (8, 8, 4)))(jkeys))
    tkeys = trandom.fold_in(
        trandom.prng_key(torch.from_numpy(lo.astype(np.int64)), "cpu"),
        torch.from_numpy(hi.astype(np.int64)))
    got = trandom.normal(trandom.fold_in(tkeys, 3), (8, 8, 4)).numpy()
    assert got.shape == (3, 8, 8, 4)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
