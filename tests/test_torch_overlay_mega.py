"""K4 and its harness against the JAX package.

* K4's plain version equals the JAX ``mega_overlay_ticks`` (interpret
  mode) on one S=16 launch from a mid-run plane;
* the port's K4 route (``make_mega_run``: two launches and a 12-tick
  remainder) equals the JAX XLA run over 44 ticks, state and metrics
  (``live_uncovered`` is -1 on this route, as on the TPU's);
* a 17-tick run resumed for 23 ticks equals one 40-tick run.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.models import overlay as jov
from gossip_protocol_tpu.models import overlay_mega as jmega
from gossip_protocol_tpu.ops.pallas.overlay_mega import \
    mega_overlay_ticks as jax_mega_overlay_ticks
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import overlay as pov
from gossip_protocol_tpu_torch.models import overlay_mega as pmega
from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import (
    MEGA_TICKS, mega_overlay_ticks, mega_overlay_ticks_plain)

torch.set_num_threads(2)

STATE_FIELDS = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
                "joinreq", "joinrep")
METRICS = ("in_group", "view_slots", "adds", "removals", "false_removals",
           "victim_slots", "sent", "recv")

SCENARIOS = {
    "ramp_fail": dict(max_nnb=64, single_failure=True, seed=3,
                      total_ticks=120, fail_tick=40, step_rate=0.5),
    "drop": dict(max_nnb=128, single_failure=True, drop_msg=True,
                 msg_drop_prob=0.3, seed=5, total_ticks=120, fail_tick=60,
                 step_rate=0.25, drop_open_tick=10, drop_close_tick=100),
    "churn": dict(max_nnb=64, single_failure=False, seed=7, total_ticks=200,
                  churn_rate=0.25, rejoin_after=30, step_rate=40.0 / 64),
    "powerlaw": dict(max_nnb=64, single_failure=True, seed=9,
                     total_ticks=120, fail_tick=50, step_rate=0.5,
                     topology="powerlaw", fanout=5),
}


def _pair(name, **over):
    kw = dict(SCENARIOS[name], model="overlay", **over)
    return JaxConfig(**kw), SimConfig(**kw)


def _assert_state(jstate, pstate):
    assert int(np.asarray(jstate.tick)) == pstate.tick
    for f in STATE_FIELDS:
        assert np.array_equal(np.asarray(getattr(jstate, f)),
                              getattr(pstate, f).numpy()), f


@pytest.mark.parametrize("name,t0", [("ramp_fail", 32), ("drop", 48)])
def test_plain_k4_equals_jax_kernel(name, t0):
    """One S=16 launch from the tick-t0 plane of an XLA run (the drop
    case at N=64: ticks 48-63 hold drops and the epoch-end re-slot)."""
    jc, pc = _pair(name, max_nnb=64)
    js = jov.make_overlay_schedule(jc)
    ps = pov.make_overlay_schedule(pc)
    mid, _ = jov.make_overlay_run(jc, t0, use_pallas=False)(
        jov.init_overlay_state(jc), js)
    plane = jmega._pack_state(jc, mid, js)
    k, f = jov.resolved_dims(jc)
    sp = jmega._sp_vector(jc, js, mid.tick, MEGA_TICKS, jc.n, f)
    # the JAX kernel's static arguments, as its make_mega_run builds them
    # (gossip_protocol_tpu/models/overlay_mega.py:153-158)
    kw = dict(n=jc.n, k=k, f_rounds=f, s_ticks=MEGA_TICKS,
              t_remove=jc.t_remove, churn_lo=jc.total_ticks // 4,
              churn_span=max(jc.total_ticks // 2, 1),
              can_rejoin=jc.churn_rate > 0 or jc.rejoin_after is not None,
              powerlaw=jc.topology == "powerlaw")
    st_j, met_j = jax_mega_overlay_ticks(plane, sp, **kw)
    assert dict(pmega.mega_kernel_kwargs(pc, ps), s_ticks=MEGA_TICKS) == kw
    sp_p = pmega._sp_vector(pc, ps, t0, MEGA_TICKS, pc.n, f)
    assert np.array_equal(sp_p, np.asarray(sp))
    st_in = torch.from_numpy(np.array(plane))
    assert torch.equal(st_in, pmega._pack_state(
        pc, pov.overlay_state_from_host(
            jov.overlay_state_to_host(mid), "cpu"), ps))
    before = mega_overlay_ticks.launches
    st_p, met_p = mega_overlay_ticks(st_in, sp_p, **kw)
    assert mega_overlay_ticks.launches == before   # CPU: plain version
    assert np.array_equal(st_p.numpy(), np.asarray(st_j))
    assert np.array_equal(met_p.numpy(), np.asarray(met_j))
    st_q, met_q = mega_overlay_ticks_plain(st_in, sp_p, **kw)
    assert torch.equal(st_q, st_p) and torch.equal(met_q, met_p)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mega_run_equals_jax_xla_run(name):
    jc, pc = _pair(name)
    assert pmega.mega_supported(pc)
    fj, mj = jov.make_overlay_run(jc, 44, use_pallas=False)(
        jov.init_overlay_state(jc), jov.make_overlay_schedule(jc))
    fp, mp = pov.make_overlay_run(pc, 44)(pov.init_overlay_state(pc, "cpu"),
                                          pov.make_overlay_schedule(pc))
    _assert_state(fj, fp)
    for f in METRICS:
        a, b = np.asarray(getattr(mj, f)), getattr(mp, f).numpy()
        assert np.array_equal(a, b), (f, np.flatnonzero(a != b)[:5])
    assert (mp.live_uncovered.numpy() == -1).all()


def test_mega_resume_bit_identical():
    _, pc = _pair("ramp_fail")
    sched = pov.make_overlay_schedule(pc)
    state = pov.init_overlay_state(pc, "cpu")
    mid, _ = pmega.make_mega_run(pc, 17)(state, sched)
    split, _ = pmega.make_mega_run(pc, 23)(mid, sched)
    once, _ = pmega.make_mega_run(pc, 40)(state, sched)
    assert split.tick == once.tick == 40
    for f in STATE_FIELDS:
        assert torch.equal(getattr(split, f), getattr(once, f)), f


def test_mega_route_equals_per_tick_route():
    """K4 and K3 per tick give the same run (the route changes no bit)."""
    _, pc = _pair("drop")
    sched = pov.make_overlay_schedule(pc)
    state = pov.init_overlay_state(pc, "cpu")
    fm, mm = pov.make_overlay_run(pc, 40, mega=True)(state, sched)
    ft, mt = pov.make_overlay_run(pc, 40, mega=False, grid=False)(state,
                                                                  sched)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(fm, f), getattr(ft, f)), f
    for f in METRICS:
        assert torch.equal(getattr(mm, f), getattr(mt, f)), f
