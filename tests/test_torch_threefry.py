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
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.dense_mega import drop_stack
from gossip_protocol_tpu_torch.ops.drop import drop_masks, tick_drop_masks
from gossip_protocol_tpu_torch.state import make_schedule_host
from gossip_protocol_tpu_torch.utils import threefry

torch.set_num_threads(2)

SEEDS = (0, 1, 12345)
TICKS = (0, 51, 300, 699)

#: the JAX draw compiled once per width (tick, window flag and
#: probability traced)
_jax_drop_jit = jax.jit(jax_drop_masks, static_argnums=2)


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
    """Per-link thresholds (the asym world) and partition groups at a
    draw narrower than the plane (a canonical bucket's real width inside
    its rung): the thresholds are read at the ``na x na`` corner, as the
    JAX tick's ``link_prob[:na, :na]`` draw, embedded at ``[:na, :na]``;
    the partition gate covers the whole plane.  Nothing raises any more;
    at full width all-ones thresholds still drop every message of an
    open tick."""
    n, na, t = 8, 6, 60
    rng = np.random.default_rng(3)
    lp = rng.random((n, n)).astype(np.float32)
    grp = np.array([0, 1, 0, 1, 1, 0, 0, 1], np.int32)
    key = jax.random.PRNGKey(0)
    g_j, q_j, p_j = (np.asarray(x) for x in jax_drop_masks(
        key, t, na, True, np.float32(0.1), link_prob=lp[:na, :na]))
    g, q, p = tick_drop_masks(threefry.prng_key(0), t, n, True,
                              np.float32(0.1), "cpu", link_prob=lp,
                              n_active=na)
    assert np.array_equal(g[:na, :na].numpy(), g_j)
    assert np.array_equal(q[:na].numpy(), q_j)
    assert np.array_equal(p[:na].numpy(), p_j)
    assert not g[na:].any() and not g[:, na:].any()
    assert not q[na:].any() and not p[na:].any()
    g2, q2, p2 = tick_drop_masks(threefry.prng_key(0), t, n, True,
                                 np.float32(0.1), "cpu", link_prob=lp,
                                 n_active=na, group=grp, part_active=True)
    cross = grp[:, None] != grp[None, :]
    assert np.array_equal(g2.numpy(), g.numpy() | cross)
    assert np.array_equal(q2.numpy(), q.numpy() | cross[:, 0])
    assert np.array_equal(p2.numpy(), p.numpy() | cross[0, :])
    lp1 = np.ones((n, n), np.float32)
    g, q, p = tick_drop_masks(threefry.prng_key(0), t, n, True,
                              np.float32(0.1), "cpu", link_prob=lp1)
    assert g.all() and q.all() and p.all()


@pytest.mark.parametrize("prob", (0.0, 0.1, 0.25, 1.0))
@pytest.mark.parametrize("s_ticks", (1, 8, 16))
@pytest.mark.parametrize("n", (10, 896))
def test_drop_stack_equals_jax_tick_by_tick(n, s_ticks, prob):
    """K2's whole-launch drop stack (one ``drop_masks`` call) equals the
    JAX package's per-tick draw at every tick of the launch, with a drop
    window that opens and closes inside it: ticks t0 + S // 2 and the
    one after are drawn, the others are not."""
    t0 = 40
    mid = t0 + s_ticks // 2
    cfg = SimConfig(max_nnb=n, seed=7, drop_msg=True, msg_drop_prob=prob,
                    drop_open_tick=mid - 1, drop_close_tick=mid + 1)
    sched = make_schedule_host(cfg)
    rng = threefry.prng_key(cfg.seed)
    g, q, p = drop_stack(rng, t0, s_ticks, n, sched, "cpu")
    assert g.shape == (s_ticks, n, n) and q.shape == p.shape == (s_ticks, n)
    key = jax.random.PRNGKey(cfg.seed)
    on = [sched.drop_on(t0 + s) for s in range(s_ticks)]
    assert on[s_ticks // 2] and not on[0] == (s_ticks > 1)
    for s in range(s_ticks):
        g_j, q_j, p_j = _jax_drop_jit(key, np.int32(t0 + s), n,
                                      np.bool_(on[s]), np.float32(prob))
        assert np.array_equal(g[s].numpy(), np.asarray(g_j)), s
        assert np.array_equal(q[s].numpy(), np.asarray(q_j)), s
        assert np.array_equal(p[s].numpy(), np.asarray(p_j)), s
    if prob == 1.0:
        assert g[s_ticks // 2].all() and not g[0].any() == (s_ticks > 1)


@pytest.mark.parametrize("n,na", ((10, 8), (896, 768)))
def test_drop_masks_embed_narrower_draw(n, na):
    """``n_active`` (``make_tick(n_active=)``, the bench corner's stream):
    the width-``na`` JAX draw sits at ``[:na, :na]`` of the plane and in
    the first ``na`` entries of the two vectors; the rest is zero."""
    rng = threefry.prng_key(11)
    key = jax.random.PRNGKey(11)
    prob = np.float32(0.25)
    t = 120
    g, q, p = tick_drop_masks(rng, t, n, True, prob, "cpu", n_active=na)
    g_j, q_j, p_j = (np.asarray(x) for x in _jax_drop_jit(
        key, np.int32(t), na, np.bool_(True), prob))
    assert g.shape == (n, n) and q.shape == p.shape == (n,)
    assert np.array_equal(g[:na, :na].numpy(), g_j)
    assert np.array_equal(q[:na].numpy(), q_j)
    assert np.array_equal(p[:na].numpy(), p_j)
    assert not g[na:].any() and not g[:, na:].any()
    assert not q[na:].any() and not p[na:].any()
    g2, q2, p2 = drop_masks(rng, t - 1, (False, True), prob, n, n_active=na)
    assert not g2[0].any() and not q2[0].any() and not p2[0].any()
    assert torch.equal(g2[1], g) and torch.equal(q2[1], q)
    assert torch.equal(p2[1], p)
