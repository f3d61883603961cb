"""hibag_tpu_torch's random streams held against hibag_tpu's: the R
Mersenne-Twister bootstrap (utils/rng.py) and the threefry replica of the
jax.random calls of the fused trainer (utils/threefry.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibag_tpu.utils.rng import RRng as JRRng
from hibag_tpu_torch.utils import threefry
from hibag_tpu_torch.utils.rng import RRng

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 100 * 7919 + 3, 2**31 - 1, -5]
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def test_threefry_mode_is_partitionable():
    # the replica implements the partitionable layout; this image's jax
    # runs with it on
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 100, 100 + 1000003 * 7])
def test_bootstrap_counts_equal(seed):
    for n in (2, 60, 1000):
        np.testing.assert_array_equal(RRng(seed).bootstrap_counts(n),
                                      JRRng(seed).bootstrap_counts(n))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(key).astype(np.int64),
                                  tkey.numpy())
    # a chain of splits, as the growth loop takes one per step
    for _ in range(5):
        parts = jax.random.split(key)
        tparts = threefry.split(tkey)
        np.testing.assert_array_equal(np.asarray(parts).astype(np.int64),
                                      tparts.numpy())
        key, tkey = parts[0], tparts[0]
    # a batch of keys at once, as the port splits K classifiers together
    batch = np.stack([np.asarray(jax.random.PRNGKey(seed + i))
                      for i in range(4)]).astype(np.int64)
    want = np.stack([np.asarray(jax.random.split(jax.random.PRNGKey(seed + i)))
                     for i in range(4)]).astype(np.int64)
    np.testing.assert_array_equal(threefry.split(torch.from_numpy(batch))
                                  .numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    for n in (1, 266, 1000):
        bits = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
        np.testing.assert_array_equal(bits.astype(np.int64),
                                      threefry.random_bits(tkey, n).numpy())
        u = np.asarray(jax.random.uniform(key, (n,), minval=TINY, maxval=1.))
        np.testing.assert_array_equal(u, threefry.uniform_low(tkey, n).numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_gumbel_within_an_ulp_per_log(seed):
    """The two float32 logs of gumbel are each library's own, and each is
    faithful (within one ulp of the exact value), so the two sides may
    differ by one ulp at the inner log, x = -log(u), and the outer log
    carries that ulp on as ulp(x)/x before rounding it, within an ulp, on
    each side: |Δg| <= ulp(x)/x + 2 ulp(g). Bitwise equality is not to be
    had from two log implementations; the draw does not depend on it
    (threefry.draw_top_k ranks the uniforms' bits, which are bitwise)."""
    key = jax.random.PRNGKey(seed)
    n = 20000
    g = np.asarray(jax.random.gumbel(key, (n,))).astype(np.float64)
    tg = threefry.gumbel(threefry.prng_key(seed), n).numpy().astype(np.float64)
    u = threefry.uniform_low(threefry.prng_key(seed), n).numpy()
    x = -np.log(u.astype(np.float64))
    bound = (2 * np.spacing(np.abs(g).astype(np.float32))
             + np.spacing(x.astype(np.float32)) / x)
    assert np.all(np.abs(g - tg) <= bound)
    # the inner log alone: within one ulp
    xj = np.asarray(-jnp.log(jnp.asarray(u)))
    xt = (-torch.log(torch.from_numpy(u.copy()))).numpy()
    assert np.all(np.abs(xj.astype(np.float64) - xt) <= np.spacing(xj))


def _jax_draw(key, pool, k):
    """train_fused.py:167-170 of hibag_tpu for one classifier."""
    key, k1 = jax.random.split(key)
    gumbel = jax.random.gumbel(k1, (pool.shape[0],))
    score = jnp.where(pool, gumbel, -jnp.inf)
    return key, np.asarray(jax.lax.top_k(score, k)[1])


def test_candidate_draws_equal_over_50_steps():
    """50 growth steps of a classifier with a shrinking pool: the drawn
    candidate indices (in top_k's order) are equal at every step, the pool
    falling below mtry included."""
    rng = np.random.default_rng(0)
    P, mtry = 266, 17
    key = jax.random.PRNGKey(100 * 7919 + 2)
    tkey = threefry.prng_key(100 * 7919 + 2)[None]
    pool = np.ones(P, bool)
    pool[rng.choice(P, 30, replace=False)] = False
    for step in range(50):
        key, want = _jax_draw(key, jnp.asarray(pool), mtry)
        keys = threefry.split(tkey)
        tkey = keys[:, 0]
        got = threefry.draw_top_k(keys[:, 1], torch.from_numpy(pool)[None],
                                  mtry)[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        np.testing.assert_array_equal(np.asarray(key).astype(np.int64),
                                      tkey[0].numpy())
        # drop a few drawn candidates from the pool, as a step does
        pool[want[:int(rng.integers(1, mtry))]] = False
        if pool.sum() < 5:
            pool[rng.choice(P, 40, replace=False)] = True


def test_prng_key_range():
    with pytest.raises(ValueError, match="32-bit"):
        threefry.prng_key(2**31)
