"""K3's plain version equals the JAX package's ``fused_overlay_tick``
(interpret mode on the CPU) on the inputs real runs give it.

The port's tick is run with its (N, K) phase intercepted: at every tick
the same idsaux / pw / intro / masks / scalars go through both kernels'
contracts and every output (ids, hb, ts, the six per-row counters) must
be equal.  The inputs cover the join ramp, JOINREQ aggregates, JOINREP
broadcasts, churn wipes, drops and power-law degrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_protocol_tpu.ops.pallas.overlay_exchange import \
    fused_overlay_tick as jax_fused_overlay_tick
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import overlay as pov
from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
    N_COUNTERS, fused_overlay_tick, fused_overlay_tick_plain)

torch.set_num_threads(2)

CASES = {
    # N=64 uniform F=3 through churn (wipes, rejoins, JOINREQ bursts)
    "n64_churn_f3": (dict(max_nnb=64, single_failure=False, seed=7,
                          total_ticks=120, churn_rate=0.25, rejoin_after=12,
                          step_rate=0.25), 60),
    # N=64 power-law F=7 under drops (the F > 4 case; F <= 7 keeps
    # XLA:CPU's interpret mode clear of its 8-round pathology)
    "n64_powerlaw_f7": (dict(max_nnb=64, single_failure=True, seed=13,
                             total_ticks=80, fail_tick=30, step_rate=0.5,
                             topology="powerlaw", fanout=7, drop_msg=True,
                             msg_drop_prob=0.2, drop_open_tick=5,
                             drop_close_tick=60), 50),
    # N=32, one block on the TPU (pure butterfly), scripted failure
    "n32_fail": (dict(max_nnb=32, single_failure=True, seed=11,
                      total_ticks=80, fail_tick=20, step_rate=0.5), 50),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k3_equals_jax_kernel(name):
    kw, ticks = CASES[name]
    cfg = SimConfig(model="overlay", **kw)
    seen = []

    def both(idsaux, pw, intro, masks, scalars, **kk):
        got = fused_overlay_tick_plain(idsaux, pw, intro, masks, scalars,
                                       **kk)
        want = jax_fused_overlay_tick(
            jnp.asarray(idsaux.numpy()), jnp.asarray(pw.numpy()),
            jnp.asarray(intro.numpy()), jnp.asarray(masks, jnp.int32),
            jnp.asarray(scalars, jnp.int32), **kk)
        for field, a, b in zip(("ids", "hb", "ts", "counters"), got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), \
                (name, scalars[0], field)
        seen.append(int(got[3][:, 0].sum()))
        return got

    tick = pov.make_overlay_tick(cfg, exchange=both)
    sched = pov.make_overlay_schedule(cfg)
    state = pov.init_overlay_state(cfg, "cpu")
    cols = pov.schedule_columns(sched, cfg.n, "cpu")
    for _ in range(ticks):
        state, _ = tick(state, sched, cols)
    assert len(seen) == ticks and sum(seen) > 0


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    n, k, f = 16, 8, 3
    ids = rng.integers(-1, n, (n, k)).astype(np.int32)
    aux = np.concatenate([ids, rng.integers(0, 9, (n, 1)),
                          rng.integers(0, 8, (n, 1)),
                          rng.integers(0, 2, (n, f))], 1).astype(np.int32)
    pw = np.where(ids >= 0, ((rng.integers(20, 40, (n, k)) + 1) << 12)
                  | (rng.integers(0, 9, (n, k)) + 1), 0).astype(np.int32)
    intro = np.zeros((8, k), np.int32)
    args = (torch.from_numpy(aux), torch.from_numpy(pw),
            torch.from_numpy(intro), [3, 5, 9], [40, 1, 2, 3, 30, 5, 0, 40])
    kw = dict(k=k, t_remove=20, churn_lo=10, churn_span=20)
    before = fused_overlay_tick.launches
    a = fused_overlay_tick(*args, **kw)
    b = fused_overlay_tick_plain(*args, **kw)
    assert fused_overlay_tick.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[3].shape == (n, N_COUNTERS)
