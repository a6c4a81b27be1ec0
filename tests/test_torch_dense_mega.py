"""K2: the plain ``dense_mega_ticks`` equals the TPU kernel run in
Pallas interpret mode, and the port's megakernel route equals the
port's per-tick route.

The launch inputs are a random mid-run state with a join ramp, a
failure inside the launch and (for churn) a rejoin inside it, plus a
random drop stack.  Exact equality on every output.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.ops.pallas.dense_mega import \
    dense_mega_ticks as jax_dense_mega_ticks
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.dense_mega import (dense_mega_supported,
                                                       make_dense_mega_run)
from gossip_protocol_tpu_torch.core.tick import make_tick_run
from gossip_protocol_tpu_torch.ops.cuda.dense_mega import (
    DENSE_MEGA_TICKS, dense_mega_ticks, dense_mega_ticks_for)
from gossip_protocol_tpu_torch.state import init_state, make_schedule

torch.set_num_threads(2)

T0 = 90
T_REMOVE = 20
S = 4


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    never = np.iinfo(np.int32).max
    start = (0.25 * np.arange(n) + 60).astype(np.int32)
    fail = np.full(n, never, np.int32)
    rejoin = np.full(n, never, np.int32)
    victims = rng.random(n) < 0.25
    victims[0] = False
    fail[victims] = T0
    rejoin[victims] = T0 + 2
    aux = np.stack([rng.random(n) < 0.8, rng.integers(0, 90, n),
                    rng.random(n) < 0.3, rng.random(n) < 0.3,
                    start, fail, rejoin, np.zeros(n)], 1).astype(np.int32)
    return dict(
        known=(rng.random((n, n)) < 0.7).astype(np.int32),
        hb=rng.integers(0, 90, (n, n), dtype=np.int32),
        ts=rng.integers(T0 - 2 * T_REMOVE, T0 + 1, (n, n), dtype=np.int32),
        gossip=(rng.random((n, n)) < 0.6).astype(np.int32), aux=aux,
        gdrop=rng.random((S, n, n)) < 0.1, qdrop=rng.random((S, n)) < 0.2,
        pdrop=rng.random((S, n)) < 0.2)


@pytest.mark.parametrize("n", (16, 32))
@pytest.mark.parametrize("with_events,can_rejoin",
                         ((True, True), (False, True), (True, False),
                          (False, False)))
def test_dense_mega_plain_equals_pallas_interpret(n, with_events,
                                                  can_rejoin):
    x = _inputs(n, seed=n)
    kw = dict(n=n, s_ticks=S, t_remove=T_REMOVE, can_rejoin=can_rejoin,
              with_events=with_events)
    want = jax_dense_mega_ticks(**x, sp=np.array([T0], np.int32),
                                interpret=True, **kw)
    before = dense_mega_ticks.launches
    got = dense_mega_ticks(**{k: torch.from_numpy(v) for k, v in x.items()},
                           sp=T0, **kw)
    assert dense_mega_ticks.launches == before   # CPU: plain version
    assert len(got) == len(want) == (9 if with_events else 7)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, i
        assert np.array_equal(a.numpy(), b), i


def _cfg(scenario, n=32):
    base = dict(max_nnb=n, seed=3, total_ticks=100, fail_tick=40)
    if scenario == "drop":
        base.update(drop_msg=True, msg_drop_prob=0.25, drop_open_tick=10,
                    drop_close_tick=80)
    if scenario == "churn":
        base.update(rejoin_after=25)
    return SimConfig(single_failure=scenario != "multi", **base)


@pytest.mark.parametrize("scenario", ("multi", "drop", "churn"))
def test_mega_route_equals_per_tick_route(scenario):
    """100 ticks = 6 full launches + a remainder launch of 4."""
    cfg = _cfg(scenario)
    sched = make_schedule(cfg, "cpu")
    f1, e1 = make_tick_run(cfg, with_events=True)(init_state(cfg, "cpu"),
                                                  sched)
    f2, e2 = make_dense_mega_run(cfg, with_events=True)(
        init_state(cfg, "cpu"), sched)
    assert f1.tick == f2.tick == cfg.total_ticks
    for name in ("in_group", "own_hb", "known", "hb", "ts", "gossip",
                 "joinreq", "joinrep"):
        assert torch.equal(getattr(f1, name), getattr(f2, name)), name
    for name in ("added", "removed", "sent", "recv"):
        assert torch.equal(getattr(e1, name), getattr(e2, name)), name


def test_envelope_and_ticks_per_launch():
    assert dense_mega_ticks_for(512) == DENSE_MEGA_TICKS == 16
    assert dense_mega_ticks_for(896) == DENSE_MEGA_TICKS // 2
    assert dense_mega_supported(SimConfig(max_nnb=512), with_events=True)
    assert not dense_mega_supported(SimConfig(max_nnb=520), with_events=True)
    assert dense_mega_supported(SimConfig(max_nnb=1024))
    assert not dense_mega_supported(SimConfig(max_nnb=10))
