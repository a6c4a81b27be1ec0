"""K5's route against the JAX package (exact equality).

* the port's ``make_grid_run`` (K5's plain version on the CPU) equals
  the JAX XLA run on every state field and the 8 kernel metrics, with
  ``live_uncovered`` = -1, pinned (segmented plan) and unpinned
  (all-live), on the scenarios of ``tests/test_overlay_grid.py``, and
  over a whole churn run;
* resume, the plane round trip, the envelope, the clock guard;
* a B=2 fleet lane by lane against the JAX XLA runs of its seeds;
* one launch of K5's plain version equals the interpret-mode JAX K5 on
  the same ``init`` and ``sp``, with all phases live and with the
  steady-state flags;
* routing, the ``--model overlay`` CLI on the K5 route, and
  ``OverlaySimulation.run(profile_dir=)``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.models import overlay as jov
from gossip_protocol_tpu.models import overlay_grid as jgrid
from gossip_protocol_tpu.ops.pallas.overlay_grid import \
    grid_overlay_ticks as jax_grid_overlay_ticks
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import overlay as pov
from gossip_protocol_tpu_torch.models import overlay_grid as pgrid
from gossip_protocol_tpu_torch.models import overlay_mega as pmega
from gossip_protocol_tpu_torch.models.segments import (ALL_LIVE, PhaseFlags,
                                                       plan_segments)
from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import (
    GRID_TICKS, grid_overlay_ticks, grid_overlay_ticks_plain)
from tests.conftest import TESTCASES

torch.set_num_threads(2)

STATE_FIELDS = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
                "joinreq", "joinrep")
METRICS = ("in_group", "view_slots", "adds", "removals", "false_removals",
           "victim_slots", "sent", "recv")

#: tests/test_overlay_grid.py:35-76
SCENARIOS = {
    "ramp_fail": dict(max_nnb=64, single_failure=True, seed=3,
                      total_ticks=120, fail_tick=40, step_rate=0.5),
    "drop": dict(max_nnb=128, single_failure=True, drop_msg=True,
                 msg_drop_prob=0.3, seed=5, total_ticks=120, fail_tick=60,
                 step_rate=0.25, drop_open_tick=10, drop_close_tick=100),
    "churn": dict(max_nnb=64, single_failure=False, seed=7, total_ticks=200,
                  churn_rate=0.25, rejoin_after=30, step_rate=40.0 / 64),
}

#: the JAX kernel's row-block height in its tests (two blocks at N=64)
JAX_BLOCK = 32


def _pair(name, **over):
    kw = dict(SCENARIOS[name], model="overlay", **over)
    return JaxConfig(**kw), SimConfig(**kw)


def _assert_run(jrun, prun, lane=None):
    """A JAX XLA run ``(final, metrics)`` equals a port run (or lane
    ``lane`` of a fleet run)."""
    (fj, mj), (fp, mp) = jrun, prun
    assert int(np.asarray(fj.tick)) == fp.tick
    for f in STATE_FIELDS:
        got = getattr(fp, f) if lane is None else getattr(fp, f)[lane]
        assert np.array_equal(np.asarray(getattr(fj, f)), got.numpy()), f
    for f in METRICS:
        a = np.asarray(getattr(mj, f))
        b = (getattr(mp, f) if lane is None else getattr(mp, f)[lane]).numpy()
        assert np.array_equal(a, b), (f, np.flatnonzero(a != b)[:5])
    lu = mp.live_uncovered if lane is None else mp.live_uncovered[lane]
    assert (lu.numpy() == -1).all()


def _jax_run(jc, length, state=None):
    state = jov.init_overlay_state(jc) if state is None else state
    return jov.make_overlay_run(jc, length, use_pallas=False)(
        state, jov.make_overlay_schedule(jc))


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_grid_run_equals_jax_xla_run(name, pinned):
    """44 ticks: two whole launches and a 12-tick remainder, across two
    slot-epoch re-slots."""
    jc, pc = _pair(name)
    assert pgrid.grid_supported(pc)
    run = pgrid.make_grid_run(pc, 44, start_tick=0 if pinned else None)
    _assert_run(_jax_run(jc, 44), run(pov.init_overlay_state(pc, "cpu"),
                                      pov.make_overlay_schedule(pc)))


def test_grid_full_churn_run_equals_jax():
    """The whole churn run: ramp, churn fails, rejoins, steady state,
    through the segmented plan's four kernel variants."""
    jc, pc = _pair("churn")
    assert len({s.flags for s in plan_segments(pc, 200, 0, 16)}) >= 3
    out = pgrid.make_grid_run(pc, 200, start_tick=0)(
        pov.init_overlay_state(pc, "cpu"), pov.make_overlay_schedule(pc))
    _assert_run(_jax_run(jc, 200), out)
    assert int(out[0].in_group.sum()) == pc.n


@pytest.mark.parametrize("pinned", [True, False])
def test_grid_resume_bit_identical(pinned):
    """17 ticks, then 23 from the resumed clock, equal one 40-tick run."""
    _, pc = _pair("ramp_fail")
    sched = pov.make_overlay_schedule(pc)
    state = pov.init_overlay_state(pc, "cpu")
    mid, _ = pgrid.make_grid_run(pc, 17, 0 if pinned else None)(state, sched)
    split, m2 = pgrid.make_grid_run(pc, 23, 17 if pinned else None)(mid,
                                                                     sched)
    once, m1 = pgrid.make_grid_run(pc, 40, 0 if pinned else None)(state,
                                                                   sched)
    assert split.tick == once.tick == 40
    for f in STATE_FIELDS:
        assert torch.equal(getattr(split, f), getattr(once, f)), f
    assert torch.equal(m2.sent, m1.sent[17:])


def test_grid_plane_roundtrip_equals_jax_plane():
    jc, pc = _pair("churn")
    mid, _ = _jax_run(jc, 30)
    pst = pov.overlay_state_from_host(jov.overlay_state_to_host(mid), "cpu")
    plane = pgrid.pack_grid_plane(pc, pst)
    assert np.array_equal(plane.numpy(),
                          np.asarray(jgrid.pack_grid_plane(jc, mid)))
    back = pgrid.unpack_grid_plane(pc, plane, pst.tick)
    assert back.tick == pst.tick == 30
    for f in STATE_FIELDS + ("send_hist",):
        assert torch.equal(getattr(back, f), getattr(pst, f)), f


ENVELOPE = {
    "churn64": dict(SCENARIOS["churn"]),
    "n16k": dict(max_nnb=1 << 14, single_failure=True, total_ticks=100,
                 step_rate=40.0 / (1 << 14)),
    "wide_view": dict(max_nnb=64, single_failure=True, total_ticks=100,
                      step_rate=0.5, overlay_view=65),
    "narrow_view": dict(max_nnb=64, single_failure=True, total_ticks=100,
                        step_rate=0.5, overlay_view=4),
    "fanout9": dict(max_nnb=64, single_failure=True, total_ticks=100,
                    step_rate=0.5, fanout=9),
    "long": dict(max_nnb=64, single_failure=True, total_ticks=4095,
                 step_rate=0.5),
    "ramp_overflow": dict(max_nnb=1 << 20, single_failure=True,
                          total_ticks=100, step_rate=4096.0 / 4097),
    "powerlaw1m": dict(max_nnb=1 << 20, single_failure=True,
                       total_ticks=272, fail_tick=136,
                       step_rate=40.0 / (1 << 20), topology="powerlaw"),
}


@pytest.mark.parametrize("name", sorted(ENVELOPE))
def test_grid_supported_envelope_equals_jax(name):
    kw = dict(ENVELOPE[name], model="overlay")
    assert pgrid.grid_supported(SimConfig(**kw)) == \
        jgrid.grid_supported(JaxConfig(**kw))


def test_grid_supported_covers_baseline_sizes():
    assert pgrid.grid_supported(SimConfig(**ENVELOPE["powerlaw1m"],
                                          model="overlay"))
    assert not pgrid.grid_supported(SimConfig(**ENVELOPE["wide_view"],
                                              model="overlay"))


def test_clock_guard_raises_on_a_wrong_tick():
    _, pc = _pair("churn")
    sched = pov.make_overlay_schedule(pc)
    mid, _ = pgrid.make_grid_run(pc, 16, start_tick=0)(
        pov.init_overlay_state(pc, "cpu"), sched)
    with pytest.raises(ValueError, match="start tick"):
        pgrid.make_grid_run(pc, 32, start_tick=0)(mid, sched)
    fleet = pgrid.make_grid_fleet_run(pc, 16, 1, start_tick=0)
    with pytest.raises(ValueError, match="start tick"):
        fleet(pgrid.stack_states([mid]), [sched])
    # unpinned runs resume from any clock
    pgrid.make_grid_run(pc, 4, start_tick=None)(mid, sched)


def test_grid_fleet_lanes_equal_jax_and_solo():
    """B=2 churn fleet (seeds 7 and 8), 44 ticks from tick 0: each lane
    equals the JAX XLA run of its seed and the port's solo K5 run."""
    seeds = (7, 8)
    pairs = [_pair("churn", seed=s) for s in seeds]
    pc = pairs[0][1]
    scheds = [pov.make_overlay_schedule(p) for _, p in pairs]
    states = pgrid.stack_states([pov.init_overlay_state(pc, "cpu")] * 2)
    finals, mets = pgrid.make_grid_fleet_run(pc, 44, 2)(states, scheds)
    assert finals.ids.shape == (2, pc.n, pov.resolved_dims(pc)[0])
    for b, (jc, p) in enumerate(pairs):
        _assert_run(_jax_run(jc, 44), (finals, mets), lane=b)
        solo = pgrid.make_grid_run(p, 44, start_tick=0)(
            pov.init_overlay_state(p, "cpu"), scheds[b])
        lane = pgrid.lane_state(finals, b)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(lane, f), getattr(solo[0], f)), f


#: (config, launch tick, flags) of the two launches held against the JAX
#: kernel: all phases live across churn fails and the epoch-end re-slot,
#: and a steady-state launch (ramp over, failure at 100, no drops) that
#: also re-slots
KERNEL_CASES = {
    "all_live": ("churn", {}, 48, ALL_LIVE),
    "steady": ("ramp_fail", dict(fail_tick=100), 48,
               PhaseFlags(False, False, False, False)),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_k5_equals_jax_interpret_kernel(case):
    name, over, t0, flags = KERNEL_CASES[case]
    jc, pc = _pair(name, **over)
    assert plan_segments(pc, GRID_TICKS, t0, GRID_TICKS)[0].flags == flags \
        or flags == ALL_LIVE
    js = jov.make_overlay_schedule(jc)
    mid, _ = _jax_run(jc, t0)
    plane = jgrid.pack_grid_plane(jc, mid)
    init = jnp.concatenate([plane, jgrid._boot_rows(jc, js, plane, mid.tick)])
    k, f = jov.resolved_dims(jc)
    sp = jgrid._sp_vector(js, mid.tick, GRID_TICKS, jc.n, f)
    plane2_j, met_j = jax_grid_overlay_ticks(
        init, sp, s_ticks=GRID_TICKS, interpret=True,
        **jgrid._grid_kern_kwargs(jc, k, f, JAX_BLOCK),
        **flags.as_kernel_kwargs())
    # the port builds the same inputs from the same state
    pst = pov.overlay_state_from_host(jov.overlay_state_to_host(mid), "cpu")
    p_plane = pgrid.pack_grid_plane(pc, pst)
    p_boot, p_sp = pgrid.grid_launch_input(
        pc, pov.make_overlay_schedule(pc), p_plane, t0, GRID_TICKS)
    assert np.array_equal(torch.cat([p_plane, p_boot]).numpy(),
                          np.asarray(init))
    assert np.array_equal(p_sp, np.asarray(sp))
    kw = dict(pgrid.grid_kernel_kwargs(pc, k, f), s_ticks=GRID_TICKS,
              **flags.as_kernel_kwargs())
    before = grid_overlay_ticks.launches
    plane2, met, _ = grid_overlay_ticks(p_plane, p_sp, **kw)
    assert grid_overlay_ticks.launches == before      # CPU: plain version
    end = GRID_TICKS % 2
    assert np.array_equal(plane2[end].numpy(), np.asarray(plane2_j)[end])
    assert np.array_equal(met.numpy(), np.asarray(met_j))
    again = grid_overlay_ticks_plain(p_plane, p_sp, **kw)
    assert torch.equal(again[0], plane2) and torch.equal(again[1], met)


def test_routing():
    """K4 at N <= 4096 where it fits, K5 above it and for F=8 (outside
    K4's F <= 7), the per-tick K3 route only on request; ``exchange``
    only replaces K3 on the per-tick route."""
    def route(run):
        return run.__qualname__.split(".")[0]

    small = SimConfig(model="overlay", **SCENARIOS["churn"])
    f8 = small.replace(topology="powerlaw")
    assert route(pov.make_overlay_run(small, 4)) == "make_mega_run"
    assert route(pov.make_overlay_run(f8, 4)) == "make_grid_run"
    assert route(pov.make_overlay_run(small, 4, mega=False)) == \
        "make_grid_run"
    assert route(pov.make_overlay_run(f8, 4, grid=False)) == \
        "make_overlay_run"
    with pytest.raises(ValueError, match="per-tick route only"):
        pov.make_overlay_run(f8, 4, exchange=grid_overlay_ticks_plain)
    # the K5 route of an F=8 run equals its per-tick route
    sched = pov.make_overlay_schedule(f8)
    a = pov.make_overlay_run(f8, 40, start_tick=0)(
        pov.init_overlay_state(f8, "cpu"), sched)
    b = pov.make_overlay_run(f8, 40, grid=False)(
        pov.init_overlay_state(f8, "cpu"), sched)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    for f in METRICS:
        assert torch.equal(getattr(a[1], f), getattr(b[1], f)), f


@pytest.mark.parametrize("extra", [
    ["--topology", "powerlaw", "-n", "32", "--ticks", "60"],   # F=8
    ["-n", "8192", "--ticks", "48"]])                         # N > 4096
def test_cli_grid_route_json_equals_jax_cli(tmp_path, extra):
    """The port's ``--model overlay`` CLI takes K5 for these runs (F=8,
    outside K4; N above K4's 4096) and prints the JAX CLI's line."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(TESTCASES),
               JAX_PLATFORMS="cpu")
    args = [os.path.join(TESTCASES, "singlefailure.conf"), "--model",
            "overlay", *extra]
    cfg = SimConfig.from_conf(args[0], model="overlay", max_nnb=int(
        extra[extra.index("-n") + 1]), topology=(
        "powerlaw" if "powerlaw" in extra else "uniform"))
    assert pgrid.grid_supported(cfg) and not pmega.mega_supported(cfg)
    out = {}
    for pkg, extra in (("gossip_protocol_tpu", ["--platform", "cpu"]),
                       ("gossip_protocol_tpu_torch", ["--device", "cpu"])):
        proc = subprocess.run([sys.executable, "-m", pkg, *args, *extra],
                              env=env, cwd=str(tmp_path), capture_output=True,
                              text=True, check=True)
        out[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    a, b = out["gossip_protocol_tpu"], out["gossip_protocol_tpu_torch"]
    for key in ("wall_s", "node_ticks_per_s"):
        a.pop(key)
        b.pop(key)
    assert a == b


def test_simulation_profile_dir_writes_a_trace(tmp_path):
    """``run(profile_dir=)`` writes a torch.profiler trace there and
    changes no result; the K5 route pins its plan at the state's clock."""
    _, pc = _pair("ramp_fail")
    pc = pc.replace(topology="powerlaw", total_ticks=60)
    sim = pov.OverlaySimulation(pc, device="cpu")
    plain = sim.run(ticks=40)
    traced = sim.run(profile_dir=str(tmp_path / "prof"), ticks=40)
    files = os.listdir(tmp_path / "prof")
    assert files == ["overlay_n64_t0-40.json"]
    with open(tmp_path / "prof" / files[0]) as f:
        assert json.load(f)["traceEvents"]
    for f in STATE_FIELDS:
        assert torch.equal(getattr(plain.final_state, f),
                           getattr(traced.final_state, f)), f
    for f in METRICS:
        assert np.array_equal(getattr(plain.metrics, f),
                              getattr(traced.metrics, f)), f
    rest = sim.run(resume_from=plain.final_state)
    assert rest.final_state.tick == 60


#: the two K5 configurations at N=64 for the boot block: BASELINE's churn
#: shape, and the power-law shape with seed 77, whose single victim is the
#: introducer (fail tick 136), without and with a rejoin 40 ticks later
BOOT_CASES = {
    "churn": dict(max_nnb=64, single_failure=False, seed=1, total_ticks=608,
                  churn_rate=0.2, rejoin_after=40, step_rate=1.0),
    "powerlaw_intro_fails": dict(max_nnb=64, single_failure=True, seed=77,
                                 total_ticks=272, fail_tick=136,
                                 topology="powerlaw", step_rate=40.0 / 64),
    "powerlaw_intro_rejoins": dict(max_nnb=64, single_failure=True, seed=77,
                                   total_ticks=272, fail_tick=136,
                                   rejoin_after=40, topology="powerlaw",
                                   step_rate=40.0 / 64),
}
BOOT_TICKS = (0, 1, 17, 100, 136, 137, 160, 176, 177, 255)


@pytest.mark.parametrize("name", sorted(BOOT_CASES))
def test_boot_rows_equal_jax(name):
    """The port's ``_boot_rows`` (the plain version of K5's boot
    pre-pass) equals the JAX package's on a random plane (about half the
    rows with their joinreq bit set) at join-live ticks inside and
    outside the introducer's fail window; the join-dead form keeps only
    row 0."""
    kw = dict(BOOT_CASES[name], model="overlay")
    jc, pc = JaxConfig(**kw), SimConfig(**kw)
    js, ps = jov.make_overlay_schedule(jc), pov.make_overlay_schedule(pc)
    fail0, rejoin0 = pgrid._intro_window(ps)
    if name != "churn":
        assert fail0 == 136 and any(fail0 < t <= rejoin0 for t in BOOT_TICKS)
    rng = np.random.default_rng(len(name))
    plane = rng.integers(-2 ** 31, 2 ** 31, (pc.n, 128), dtype=np.int64) \
        .astype(np.int32)
    for t0 in BOOT_TICKS:
        want = np.asarray(jgrid._boot_rows(jc, js, jnp.asarray(plane),
                                           jnp.int32(t0)))
        got = pgrid._boot_rows(pc, ps, torch.from_numpy(plane), t0)
        assert np.array_equal(got.numpy(), want), t0
        dead = pgrid._boot_rows(pc, ps, torch.from_numpy(plane), t0,
                                join_live=False)
        assert np.array_equal(dead[0].numpy(), plane[0])
        assert not dead[1:].any()


def test_boot_prepass_plain_equals_boot_rows():
    """The pre-pass wrapper's CPU route (``grid_boot_rows_plain``, which
    reads the tick, seed and introducer window from the ``sp`` rows)
    equals ``_boot_rows`` solo and as a B=2 fleet of two seeds, and
    launches nothing."""
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import (
        grid_boot_rows, grid_boot_rows_plain)
    kw = dict(BOOT_CASES["powerlaw_intro_rejoins"], model="overlay")
    rng = np.random.default_rng(9)
    for t0 in (17, 137, 177):
        lanes = []
        for seed in (77, 5):
            pc = SimConfig(**dict(kw, seed=seed))
            plane = torch.from_numpy(rng.integers(
                -2 ** 31, 2 ** 31, (pc.n, 128), dtype=np.int64)
                .astype(np.int32))
            boot, sp = pgrid.grid_launch_input(
                pc, pov.make_overlay_schedule(pc), plane, t0, GRID_TICKS)
            lanes.append((plane, boot, sp))
        k = pov.resolved_dims(pc)[0]
        before = grid_boot_rows.launches
        assert torch.equal(grid_boot_rows(lanes[0][0], lanes[0][2], n=64,
                                          k=k), lanes[0][1][1, :k])
        assert grid_boot_rows.launches == before
        fleet = grid_boot_rows_plain(
            torch.stack([x[0] for x in lanes]),
            np.stack([x[2] for x in lanes]), n=64, k=k, batch=2)
        assert torch.equal(fleet, torch.stack([x[1][1, :k] for x in lanes]))


def test_grid_launch_without_boot():
    """A K5 launch takes no boot block (the introducer's row is read from
    the plane, the aggregate carried or built by the pre-pass): the plain
    K5 at tick 40 equals the per-tick overlay run over the same 16 ticks,
    with or without the carried aggregate, and returns the next launch's
    aggregate, row 1 of ``_boot_rows`` of its end plane at tick 56; a
    carry that is not the plane's is refused."""
    _, pc = _pair("churn")
    k, f = pov.resolved_dims(pc)
    ps = pov.make_overlay_schedule(pc)
    state, _ = pov.make_overlay_run(pc, 40)(pov.init_overlay_state(pc, "cpu"),
                                            ps)
    plane = pgrid.pack_grid_plane(pc, state)
    boot, sp = pgrid.grid_launch_input(pc, ps, plane, 40, GRID_TICKS)
    assert boot[1].any()
    kw = dict(pgrid.grid_kernel_kwargs(pc, k, f), s_ticks=GRID_TICKS)
    want, _ = pov.make_overlay_run(pc, GRID_TICKS)(state, ps)
    got = pgrid.pack_grid_plane(pc, want)
    for agg in (None, boot[1, :k]):
        plane2, _, nxt = grid_overlay_ticks_plain(plane, sp, agg=agg, **kw)
        assert torch.equal(plane2[GRID_TICKS % 2], got)
        assert torch.equal(nxt, pgrid._boot_rows(pc, ps, got, 56)[1, :k])
    with pytest.raises(AssertionError, match="carried boot aggregate"):
        grid_overlay_ticks_plain(plane, sp, agg=boot[1, :k] + 1, **kw)
