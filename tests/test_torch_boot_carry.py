"""K5's carried boot aggregate against the JAX package (exact equality).

A K5 launch's boot JOINREQ aggregate is carried from the launch before
it: the call returns the aggregate its last tick leaves for tick t0 + S,
and the run loop hands it to the next call.  At every launch of the K5
route (the plain K5 on the CPU) the carried aggregate equals row 1 of
the JAX package's ``_boot_rows`` of the launch's output plane at t0 + S
and of the port's ``_boot_rows``; the runs' final states and metrics
equal the JAX XLA runs; the boot pre-pass is called only for a run's
first launch when it starts join-live at a tick > 0.  Covered: the
churn and power-law shapes, a power-law config whose introducer fails
and rejoins with launch boundaries on either side of both ticks, a
12-tick remainder, a run started at a nonzero tick, a B=2 fleet, and a
join-dead launch followed by a join-live one.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.models import overlay as jov
from gossip_protocol_tpu.models import overlay_grid as jgrid
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import overlay as pov
from gossip_protocol_tpu_torch.models import overlay_grid as pgrid
from gossip_protocol_tpu_torch.models.segments import (ALL_LIVE, PhaseFlags,
                                                       phase_windows,
                                                       plan_segments)
from gossip_protocol_tpu_torch.ops.cuda import overlay_grid as ogk

torch.set_num_threads(2)

STATE_FIELDS = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
                "joinreq", "joinrep")
METRICS = ("in_group", "view_slots", "adds", "removals", "false_removals",
           "victim_slots", "sent", "recv")

CONFIGS = {
    # tests/test_overlay_grid.py:35-76's churn scenario
    "churn": dict(max_nnb=64, single_failure=False, seed=7, total_ticks=200,
                  churn_rate=0.25, rejoin_after=30, step_rate=40.0 / 64),
    # the power-law shape; seed 77 makes the introducer the scripted
    # victim: it fails at 136 and rejoins at 176
    "powerlaw_intro": dict(max_nnb=64, single_failure=True, seed=77,
                           total_ticks=272, fail_tick=136, rejoin_after=40,
                           topology="powerlaw", step_rate=40.0 / 64),
    "powerlaw": dict(max_nnb=128, single_failure=True, seed=3,
                     total_ticks=272, fail_tick=136, topology="powerlaw",
                     step_rate=40.0 / 128),
}

#: (config, start tick, ticks): whole launches and a 12-tick remainder;
#: at 0 the pre-pass never runs, at 121 it runs once, and the launch
#: boundaries fall at 137 (the introducer's first failed tick), 153, 169
#: and 185 (past its rejoin at 176), at 0 on 128, 144 and 176 itself
RUNS = {
    "churn_0": ("churn", 0, 92),
    "powerlaw_intro_0": ("powerlaw_intro", 0, 204),
    "powerlaw_intro_121": ("powerlaw_intro", 121, 76),
    "powerlaw_121": ("powerlaw", 121, 44),
}


def _pair(name, **over):
    kw = dict(CONFIGS[name], model="overlay", **over)
    return JaxConfig(**kw), SimConfig(**kw)


def _jax_run(jc, length, state=None):
    state = jov.init_overlay_state(jc) if state is None else state
    return jov.make_overlay_run(jc, length, use_pallas=False)(
        state, jov.make_overlay_schedule(jc))


def _to_port(jstate):
    return pov.overlay_state_from_host(jov.overlay_state_to_host(jstate),
                                       "cpu")


def _assert_run(jrun, prun, lane=None):
    (fj, mj), (fp, mp) = jrun, prun
    assert int(np.asarray(fj.tick)) == fp.tick
    for f in STATE_FIELDS:
        got = getattr(fp, f) if lane is None else getattr(fp, f)[lane]
        assert np.array_equal(np.asarray(getattr(fj, f)), got.numpy()), f
    for f in METRICS:
        got = getattr(mp, f) if lane is None else getattr(mp, f)[lane]
        assert np.array_equal(np.asarray(getattr(mj, f)), got.numpy()), f


@contextlib.contextmanager
def _launches(monkeypatch):
    """Record every K5 call of the route: its ``sp``, keywords, carried
    input aggregate and outputs."""
    calls = []
    real = pgrid.grid_overlay_ticks

    def record(plane, sp, **kw):
        out = real(plane, sp, **kw)
        calls.append(dict(sp=np.asarray(sp), kw=kw, agg_in=kw.get("agg"),
                          out=out))
        return out
    monkeypatch.setattr(pgrid, "grid_overlay_ticks", record)
    yield calls
    monkeypatch.setattr(pgrid, "grid_overlay_ticks", real)


def _check_carry(calls, lanes, k):
    """Each call's carried aggregate is the one the call before returned,
    and each returned aggregate equals row 1 of ``_boot_rows`` of the
    call's end plane at t0 + S, JAX's and the port's, lane by lane
    (``lanes``: the (JAX config, JAX schedule, port config, port
    schedule) of each lane)."""
    for i, c in enumerate(calls):
        assert c["agg_in"] is (calls[i - 1]["out"][2] if i else None)
        plane2, _, agg = c["out"]
        s_ticks = c["kw"]["s_ticks"]
        sp = c["sp"].reshape(len(lanes), -1)
        ends = plane2[..., s_ticks % 2, :, :].reshape(len(lanes), -1, 128)
        for b, (jc, js, pc, ps) in enumerate(lanes):
            t1 = int(sp[b, 0]) + s_ticks
            want_j = np.asarray(jgrid._boot_rows(
                jc, js, jnp.asarray(ends[b].numpy()), jnp.int32(t1)))[1, :k]
            want_p = pgrid._boot_rows(pc, ps, ends[b], t1)[1, :k]
            got = agg.reshape(len(lanes), k)[b]
            assert np.array_equal(got.numpy(), want_j), (i, b, t1)
            assert torch.equal(got, want_p), (i, b, t1)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_carried_aggregate_equals_jax_boot_rows(run, monkeypatch):
    name, start, length = RUNS[run]
    jc, pc = _pair(name)
    js, ps = jov.make_overlay_schedule(jc), pov.make_overlay_schedule(pc)
    k = pov.resolved_dims(pc)[0]
    if name == "powerlaw_intro":
        assert pgrid._intro_window(ps) == (136, 176)
    mid_j = _jax_run(jc, start)[0] if start else jov.init_overlay_state(jc)
    mid_p = _to_port(mid_j) if start else pov.init_overlay_state(pc, "cpu")
    calls0 = ogk.grid_boot_rows.calls
    with _launches(monkeypatch) as calls:
        out = pgrid.make_grid_run(pc, length, start_tick=start)(mid_p, ps)
    assert len(calls) == -(-length // 16)
    assert calls[-1]["kw"]["s_ticks"] == 12
    _check_carry(calls, [(jc, js, pc, ps)], k)
    # the pre-pass runs for the first launch of a join-live run at t0 > 0
    assert ogk.grid_boot_rows.calls - calls0 == (
        1 if start and calls[0]["kw"]["join_live"] else 0)
    _assert_run(_jax_run(jc, length, mid_j), out)


def test_introducer_window_agrees_with_the_plans():
    """K5's last tick writes tick t1 = t0 + S's aggregate unless the
    introducer is failed at t1, and it tests that window only in a
    churn-live launch, while ``boot_block`` always tests it.  The two
    agree because the planner keeps every launch whose t1 lies in the
    introducer's window (fail0, rejoin0] churn-live: t1 - 1, its last
    tick, lies in [fail0, rejoin0), inside the churn window.  Checked
    over every start tick 0..47 of the introducer-failing config and the
    churn and power-law shapes; in churn mode the introducer never
    fails (ops/overlay_rules.py ``_churned``)."""
    seen = 0
    for name in CONFIGS:
        _, pc = _pair(name)
        fail0, rejoin0 = pgrid._intro_window(pov.make_overlay_schedule(pc))
        win = phase_windows(pc)
        assert win.fail_lo <= fail0 or fail0 == 0x7FFFFFFF
        for start in range(48):
            t = start
            for s_ticks, flags in pgrid._launches(plan_segments(
                    pc, pc.total_ticks - start, start, 16)):
                t += s_ticks
                if fail0 < t <= rejoin0:
                    seen += 1
                    assert flags.churn_live, (name, start, t)
    assert seen > 0


def test_join_flag_never_returns():
    """A plan's join flag is monotone (``join_live`` is ``t <
    join_dead_from``), so within one run a join-dead launch is never
    followed by a join-live one."""
    for name in CONFIGS:
        _, pc = _pair(name)
        for start in (0, 17, 121):
            flags = [f.join_live for _, f in pgrid._launches(plan_segments(
                pc, pc.total_ticks - start, start, 16))]
            assert flags == sorted(flags, reverse=True), (name, start)


def test_join_dead_then_join_live_launch():
    """A join-dead launch (steady flags: its template writes no joinreq
    bit and leaves slot S zero) hands a zero aggregate to an all-live
    launch after it, which is exact at any clock: both carries equal
    JAX's ``_boot_rows`` of their planes, and the end state equals the
    JAX run."""
    kw = dict(max_nnb=64, single_failure=True, seed=3, total_ticks=120,
              fail_tick=100, step_rate=0.5, model="overlay")
    jc, pc = JaxConfig(**kw), SimConfig(**kw)
    js, ps = jov.make_overlay_schedule(jc), pov.make_overlay_schedule(pc)
    k, f = pov.resolved_dims(pc)
    steady = PhaseFlags(False, False, False, False)
    assert plan_segments(pc, 16, 48, 16)[0].flags == steady
    mid_j = _jax_run(jc, 48)[0]
    plane = pgrid.pack_grid_plane(pc, _to_port(mid_j))
    kern = pgrid.grid_kernel_kwargs(pc, k, f)
    agg, t = None, 48
    for flags in (steady, ALL_LIVE):
        sp = pgrid._sp_vector(ps, t, 16, pc.n, f)
        plane2, _, agg = ogk.grid_overlay_ticks(
            plane, sp, s_ticks=16, agg=agg, **kern,
            **flags.as_kernel_kwargs())
        plane, t = plane2[0], t + 16
        want = np.asarray(jgrid._boot_rows(jc, js, jnp.asarray(
            plane.numpy()), jnp.int32(t)))[1, :k]
        assert np.array_equal(agg.numpy(), want), t
    end_j, _ = _jax_run(jc, 32, mid_j)
    assert np.array_equal(plane.numpy(),
                          np.asarray(jgrid.pack_grid_plane(jc, end_j)))


@pytest.mark.parametrize("start", [0, 17])
def test_fleet_carry_equals_jax(start, monkeypatch):
    """A B=2 churn fleet (seeds 7 and 8): the lanes' carried aggregates
    at every launch equal JAX's ``_boot_rows`` of each lane's end plane,
    and each lane equals its JAX XLA run; started at 17 (join-live) the
    fleet calls the pre-pass once, for its first launch."""
    pairs = [_pair("churn", seed=s) for s in (7, 8)]
    pc = pairs[0][1]
    k = pov.resolved_dims(pc)[0]
    lanes = [(jc, jov.make_overlay_schedule(jc), p,
              pov.make_overlay_schedule(p)) for jc, p in pairs]
    mids = [_jax_run(jc, start)[0] if start else jov.init_overlay_state(jc)
            for jc, _ in pairs]
    states = pgrid.stack_states([_to_port(m) if start
                                 else pov.init_overlay_state(pc, "cpu")
                                 for m in mids])
    calls0 = ogk.grid_boot_rows.calls
    with _launches(monkeypatch) as calls:
        finals, mets = pgrid.make_grid_fleet_run(pc, 44, 2, start)(
            states, [ln[3] for ln in lanes])
    assert [c["kw"]["s_ticks"] for c in calls] == [16, 16, 12]
    _check_carry(calls, lanes, k)
    assert ogk.grid_boot_rows.calls - calls0 == (1 if start else 0)
    for b, (jc, _) in enumerate(pairs):
        _assert_run(_jax_run(jc, 44, mids[b]), (finals, mets), lane=b)
