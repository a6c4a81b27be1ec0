"""The port's threefry stream equals ``jax.random`` bit for bit.

``gossip_protocol_tpu_torch.utils.threefry`` re-implements
``PRNGKey`` / ``fold_in`` / ``uniform`` (partitionable threefry, jax's
default) so the port drops exactly the messages the JAX package drops.
Every comparison here is exact equality.
"""

import jax
import numpy as np
import pytest
import torch

from gossip_protocol_tpu.ops.drop import tick_drop_masks as jax_drop_masks
from gossip_protocol_tpu_torch.ops.drop import tick_drop_masks
from gossip_protocol_tpu_torch.utils import threefry

torch.set_num_threads(2)

SEEDS = (0, 1, 12345)
TICKS = (0, 51, 300, 699)


def test_partitionable_mode_is_jax_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed",
                         SEEDS + (2**31 + 5, 2**32 + 7, 2**40 + 3, -5))
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(threefry.prng_key(seed), np.asarray(key))
    for t in TICKS + (2**31 - 1,):
        want = np.asarray(jax.random.fold_in(key, t))
        got = threefry.fold_in(threefry.prng_key(seed), t)
        assert got.dtype == np.uint32
        assert np.array_equal(got, want), (seed, t)


@pytest.mark.parametrize("n", (10, 16, 64, 512, 896))
def test_uniform_and_drop_masks(n):
    """(n + 2, n) draws — n = 10 is not a multiple of 4 (the flat index
    splits across rows mid-word) — and the three drop masks."""
    prob = np.float32(0.1)
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        key_t = threefry.prng_key(seed)
        for t in TICKS:
            want = np.asarray(jax.random.uniform(jax.random.fold_in(key, t),
                                                 (n + 2, n)))
            got = threefry.uniform(threefry.fold_in(key_t, t), (n + 2, n),
                                   "cpu").numpy()
            assert got.dtype == np.float32
            assert np.array_equal(got, want), (seed, t)
            g_j, q_j, p_j = jax_drop_masks(key, t, n, True, prob)
            g, q, p = tick_drop_masks(key_t, t, n, True, prob, "cpu")
            assert np.array_equal(g.numpy(), np.asarray(g_j)), (seed, t)
            assert np.array_equal(q.numpy(), np.asarray(q_j)), (seed, t)
            assert np.array_equal(p.numpy(), np.asarray(p_j)), (seed, t)


def test_closed_window_draws_nothing():
    g, q, p = tick_drop_masks(threefry.prng_key(3), 700, 12, False,
                              np.float32(1.0), "cpu")
    assert not g.any() and not q.any() and not p.any()
    assert g.shape == (12, 12) and q.shape == (12,) and p.shape == (12,)


def test_random_bits_odd_shape():
    """Raw bits of a shape whose size is odd match ``jax.random.bits``."""
    key = jax.random.fold_in(jax.random.PRNGKey(5), 17)
    want = np.asarray(jax.random.bits(key, (7, 13), dtype=np.uint32))
    got = threefry.random_bits(np.asarray(key), (7, 13), "cpu").numpy()
    assert np.array_equal(got.astype(np.uint32), want)


def test_asym_link_prob_raises():
    with pytest.raises(NotImplementedError):
        tick_drop_masks(threefry.prng_key(0), 60, 8, True, np.float32(0.1),
                        "cpu", link_prob=np.zeros((8, 8), np.float32))
