"""The port's dense tick equals the JAX package's tick, tick by tick.

Both packages start from the same config and seed; after every tick the
whole state and the tick's events must be equal.  The runs span the
drop window's opening (t = 51) and the failure's detection
(fail + TREMOVE + 1 = 121), and cover single failure, multi failure,
10% drops, churn (``rejoin_after``) and a drop stream drawn at a
narrower width (``n_active``).  JAX runs its composable XLA
tick (``use_pallas=False``); the port runs its kernels' plain versions.
"""

import jax
import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.core.tick import make_tick as jax_make_tick
from gossip_protocol_tpu.state import init_state as jax_init_state
from gossip_protocol_tpu.state import make_schedule as jax_make_schedule
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.tick import make_tick
from gossip_protocol_tpu_torch.state import (init_state, make_schedule,
                                             state_to_host)

torch.set_num_threads(2)

STATE_FIELDS = ("tick", "in_group", "own_hb", "known", "hb", "ts", "gossip",
                "gossip_age", "joinreq", "joinrep", "rng")


def assert_state_equal(port_state, jax_state, where=""):
    """Every WorldState field equal, dtype included (port -> host dict)."""
    host = state_to_host(port_state)
    for name in STATE_FIELDS:
        a, b = host[name], np.asarray(getattr(jax_state, name))
        assert a.dtype == b.dtype, (where, name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, name)


def assert_events_equal(port_ev, jax_ev, where=""):
    for name in ("added", "removed", "sent", "recv"):
        a = getattr(port_ev, name).numpy()
        b = np.asarray(getattr(jax_ev, name))
        assert a.dtype == b.dtype, (where, name)
        assert np.array_equal(a, b), (where, name)


CASES = {
    "single": dict(single_failure=True, seed=1, total_ticks=130),
    "multi": dict(single_failure=False, seed=2, total_ticks=130),
    "drop": dict(single_failure=True, drop_msg=True, msg_drop_prob=0.1,
                 seed=3, total_ticks=160),
    "churn": dict(single_failure=False, seed=4, total_ticks=160,
                  rejoin_after=30),
    # the drop stream drawn at a narrower width and embedded (the
    # active corner's stream, consumed by a full-width tick)
    "drop_n_active": dict(single_failure=False, drop_msg=True,
                          msg_drop_prob=0.2, seed=5, total_ticks=130,
                          n_active=40),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tick_equals_jax_tick(case):
    kw = dict(max_nnb=64, **CASES[case])
    n_active = kw.pop("n_active", None)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jtick = jax.jit(jax_make_tick(jcfg, use_pallas=False, n_active=n_active))
    jsched, jstate = jax_make_schedule(jcfg), jax_init_state(jcfg)
    tick = make_tick(cfg, n_active=n_active)
    sched, state = make_schedule(cfg, "cpu"), init_state(cfg, "cpu")
    assert_state_equal(state, jstate, "init")
    seen = {"added": 0, "removed": 0}
    for t in range(cfg.total_ticks):
        jstate, jev = jtick(jstate, jsched)
        state, ev = tick(state, sched)
        assert_state_equal(state, jstate, t)
        assert_events_equal(ev, jev, t)
        seen["added"] += int(ev.added.sum())
        seen["removed"] += int(ev.removed.sum())
    # the run reached the interesting phases
    assert seen["added"] > 64 * 60 and seen["removed"] > 0
