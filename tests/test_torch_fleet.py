"""The port's fleet (gossip_protocol_tpu_torch/core/fleet.py) against the
live JAX fleet and the port's own solo runs, bit for bit.

Every lane of a port fleet must equal the same lane of the JAX
``FleetSimulation`` and the port's solo run of that lane's config:
state, events or metrics, and counters.  On the CPU the lane-axis
kernels run their plain versions, which these tests also hold against
their per-lane calls and the JAX functions.  The sizes are the JAX
package's own fleet tests' (tests/test_fleet.py, test_elastic.py).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.core import fleet as jax_fleet
from gossip_protocol_tpu.ops import merge as jax_merge
from gossip_protocol_tpu.ops.drop import tick_drop_masks as jax_drop_masks
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core import fleet
from gossip_protocol_tpu_torch.core.sim import Simulation
from gossip_protocol_tpu_torch.core.tick import (composable_lanes,
                                                 run_build_count)
from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
from gossip_protocol_tpu_torch.ops import merge
from gossip_protocol_tpu_torch.ops.cuda.tickfused import (
    tick_epilogue, tick_epilogue_plain)
from gossip_protocol_tpu_torch.ops.drop import (LaneDrop, drop_masks_lanes,
                                                tick_drop_masks)
from gossip_protocol_tpu_torch.parallel.fleet_mesh import (
    MeshFleetSimulation, make_lane_peer_mesh)
from gossip_protocol_tpu_torch.parallel.sharded import (make_mesh,
                                                        make_sharded_run,
                                                        shard_state)
from gossip_protocol_tpu_torch.state import init_state, make_schedule
from gossip_protocol_tpu_torch.utils.threefry import prng_key

torch.set_num_threads(2)

DENSE_STATE = ("in_group", "own_hb", "known", "hb", "ts", "gossip",
               "gossip_age", "joinreq", "joinrep")
OV_STATE = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
            "send_hist", "joinreq", "joinrep")
OV_METRICS = ("in_group", "view_slots", "adds", "removals",
              "false_removals", "victim_slots", "live_uncovered", "sent",
              "recv")
SEEDS = [1, 2, 3, 4]


def _dense_churn(n=32, ticks=60):
    return dict(max_nnb=n, single_failure=False, drop_msg=False, seed=0,
                total_ticks=ticks, fail_tick=20, rejoin_after=15)


def _dense_drop(n=24, ticks=80):
    return dict(max_nnb=n, single_failure=True, drop_msg=True,
                msg_drop_prob=0.1, seed=0, total_ticks=ticks, fail_tick=30)


def _overlay_churn(n=64, ticks=64):
    return dict(max_nnb=n, model="overlay", single_failure=False,
                drop_msg=False, seed=0, total_ticks=ticks, churn_rate=0.25,
                rejoin_after=16, step_rate=8.0 / n)


def _overlay_drop(n=64, ticks=64):
    return dict(max_nnb=n, model="overlay", single_failure=True,
                drop_msg=True, msg_drop_prob=0.1, seed=0, total_ticks=ticks,
                fail_tick=30, step_rate=8.0 / n, drop_open_tick=10,
                drop_close_tick=50)


def _world(**kw):
    return dict(dict(max_nnb=16, single_failure=True, drop_msg=False,
                     seed=2, total_ticks=120, fail_tick=40), **kw)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


def _dense_equal(got, want, ctx, bench=False):
    for f in ("sent", "recv") + (() if bench else ("added", "removed")):
        _eq(getattr(got, f), getattr(want, f), f"{ctx}: {f}")
    for f in DENSE_STATE:
        _eq(getattr(got.final_state, f), getattr(want.final_state, f),
            f"{ctx}: state {f}")
    assert int(got.final_state.tick) == int(want.final_state.tick), ctx


def _overlay_equal(got, want, ctx, metrics=OV_METRICS):
    for f in OV_STATE:
        _eq(getattr(got.final_state, f), getattr(want.final_state, f),
            f"{ctx}: state {f}")
    for f in metrics:
        _eq(getattr(got.metrics, f), getattr(want.metrics, f),
            f"{ctx}: metric {f}")


def _both(kw):
    return SimConfig(**kw), JaxConfig(**kw)


@pytest.mark.parametrize("mode", ["bench_churn", "trace_drop10",
                                  "trace_drop10_chunked"])
def test_dense_fleet_equals_jax_fleet_and_solo(mode):
    kw = _dense_churn() if mode == "bench_churn" else _dense_drop()
    cfg, jcfg = _both(kw)
    chunk = 16 if mode.endswith("chunked") else None
    sim = fleet.FleetSimulation(cfg, device="cpu", chunk_ticks=chunk)
    jsim = jax_fleet.FleetSimulation(jcfg, chunk_ticks=chunk)
    bench = mode == "bench_churn"
    if bench:
        got = sim.run_bench(seeds=SEEDS, warmup=False)
        want = jsim.run_bench(seeds=SEEDS, warmup=False)
    else:
        got = sim.run(seeds=SEEDS)
        want = jsim.run(seeds=SEEDS)
    assert got.batch == len(SEEDS) and got.occupancy == 1.0
    for i, s in enumerate(SEEDS):
        _dense_equal(got.lanes[i], want.lanes[i], f"lane {i} vs JAX", bench)
        solo_sim = Simulation(cfg.replace(seed=s), device="cpu")
        solo = solo_sim.run_bench(warmup=False) if bench else solo_sim.run()
        _dense_equal(got.lanes[i], solo, f"lane {i} vs solo", bench)
        assert got.lanes[i].wall_seconds == got.wall_seconds
    assert got.total_node_ticks == len(SEEDS) * cfg.n * cfg.total_ticks


@pytest.mark.parametrize("make", [_overlay_churn, _overlay_drop],
                         ids=["churn", "drop"])
def test_overlay_fleet_equals_jax_fleet_and_solo(make):
    """The plain K5 fleet (grid_supported holds at N=64) against the JAX
    vmapped XLA fleet, and against the port's solo runs (which route to
    K4 at this N); ``live_uncovered`` is -1 on every fleet route, and
    not tracked the same way on the solo K4 route."""
    cfg, jcfg = _both(make())
    got = fleet.FleetSimulation(cfg, device="cpu").run(seeds=SEEDS[:3],
                                                       warmup=False)
    want = jax_fleet.FleetSimulation(jcfg).run(seeds=SEEDS[:3],
                                               warmup=False)
    for i, s in enumerate(SEEDS[:3]):
        _overlay_equal(got.lanes[i], want.lanes[i], f"lane {i} vs JAX")
        solo = OverlaySimulation(cfg.replace(seed=s), device="cpu").run()
        _overlay_equal(got.lanes[i], solo, f"lane {i} vs solo")


def _sharded_solo(cfg, p: int):
    """A solo run on the peer-sharded tick (``make_tick(comm=RingComm)``)
    over ``p`` shards, shaped as a result for :func:`_dense_equal`."""
    mesh = make_mesh(p, device="cpu")
    final, ev = make_sharded_run(cfg, mesh)(
        shard_state(init_state(cfg, device="cpu"), mesh),
        make_schedule(cfg, device="cpu"))
    return SimpleNamespace(added=ev.added, removed=ev.removed,
                           sent=ev.sent.T, recv=ev.recv.T, final_state=final)


@pytest.mark.parametrize("world", ["asym", "zombie", "partition",
                                   "zombie-sharded"])
def test_world_fleet_equals_jax_fleet_and_solo(world):
    """A world on the K1 route (asym, partition: per-lane thresholds and
    groups in the lane-axis draw), a composable one (zombie: its lanes
    one at a time, counted), and the peer-sharded route, which a sharded
    composable world takes (zombie-sharded: one lane of a lanes x peers
    mesh, its peers over two shards, against the peer-sharded solo
    tick)."""
    extra = {"asym": dict(drop_msg=True, msg_drop_prob=0.12, asym_drop=True,
                          drop_open_tick=10, drop_close_tick=90),
             "zombie": dict(zombie=True),
             "partition": dict(partition_groups=2, partition_open_tick=30,
                               partition_close_tick=70),
             "zombie-sharded": dict(zombie=True)}[world]
    cfg, jcfg = _both(_world(**extra))
    sharded = world.endswith("-sharded")
    seeds = [2] if sharded else [2, 3, 4]
    sim = MeshFleetSimulation(cfg, make_lane_peer_mesh(1, 2, device="cpu")) \
        if sharded else fleet.FleetSimulation(cfg, device="cpu")
    before = composable_lanes.calls
    got = sim.run(seeds=seeds)
    calls = composable_lanes.calls - before
    assert calls == (len(seeds) * cfg.total_ticks if world == "zombie"
                     else 0)
    want = jax_fleet.FleetSimulation(jcfg).run(seeds=seeds)
    for i, s in enumerate(seeds):
        _dense_equal(got.lanes[i], want.lanes[i], f"{world} lane {i} vs JAX")
        solo = _sharded_solo(cfg.replace(seed=s), 2) if sharded else \
            Simulation(cfg.replace(seed=s), device="cpu").run()
        _dense_equal(got.lanes[i], solo, f"{world} lane {i} vs solo")


def test_grader_fleet_grades_90_and_mixed_shapes_refused(tmp_path):
    from gossip_protocol_tpu_torch.grader import grade_all_fleet
    res = grade_all_fleet("testcases", str(tmp_path), device="cpu")
    assert res["total"] == 90, res
    kw = _dense_churn()
    cfg, jcfg = _both(kw)
    other = dict(kw, total_ticks=kw["total_ticks"] + 1, max_nnb=40)
    with pytest.raises(ValueError) as got:
        fleet.FleetSimulation(cfg, device="cpu").run_bench(
            configs=[cfg, SimConfig(**other)])
    with pytest.raises(ValueError) as want:
        jax_fleet.FleetSimulation(jcfg).run_bench(
            configs=[jcfg, JaxConfig(**other)])
    assert str(got.value) == str(want.value)
    assert "lane 1" in str(got.value) and "max_nnb=40" in str(got.value)
    with pytest.raises(ValueError, match="exactly one"):
        fleet.FleetSimulation(cfg, device="cpu").run_bench()


def test_n_real_filler_lanes():
    """A padded fleet hands back only its real lanes, equal to the
    unpadded fleet's; the filler never reaches the event staging."""
    cfg = SimConfig(**_dense_drop(n=16, ticks=40))
    sim = fleet.FleetSimulation(cfg, device="cpu")
    full = sim.run(seeds=[5, 6])
    padded = sim.run(seeds=[5, 6, 7, 8], n_real=2)
    assert padded.batch == 2 and padded.padded_batch == 4
    assert padded.occupancy == 0.5
    for i in range(2):
        _dense_equal(padded.lanes[i], full.lanes[i], f"lane {i}")
    bench = sim.run_bench(seeds=[5, 6, 7], n_real=1, warmup=False)
    assert bench.batch == 1
    _dense_equal(bench.lanes[0], full.lanes[0], "bench lane 0", bench=True)
    with pytest.raises(ValueError, match="n_real"):
        sim.run(seeds=[5, 6], n_real=3)


def test_launch_defer_start_resolve_and_no_rebuild():
    cfg = SimConfig(**_overlay_churn())
    sim = fleet.FleetSimulation(cfg, device="cpu")
    ref = sim.run(seeds=[7, 8], warmup=False)
    pending = sim.launch(seeds=[7, 8], warmup=False, defer=True)
    assert not pending.started and not pending.is_ready()
    pending.start()
    assert pending.started and pending.is_ready()
    res = pending.resolve()
    assert pending.resolve() is res
    for i in range(2):
        _overlay_equal(res.lanes[i], ref.lanes[i], f"lane {i}")
    assert res.wall_seconds == pytest.approx(
        res.pack_seconds + res.device_seconds + res.fetch_seconds, rel=1e-6)
    # a deferred launch resolves without an explicit start
    dcfg = SimConfig(**_dense_drop(n=16, ticks=30))
    dsim = fleet.FleetSimulation(dcfg, device="cpu")
    solo = Simulation(dcfg.replace(seed=5), device="cpu").run_bench(
        warmup=False)
    got = dsim.launch_bench(seeds=[5, 6], warmup=False, defer=True).resolve()
    _dense_equal(got.lanes[0], solo, "deferred bench lane 0", bench=True)
    # a deferred leg waits for start(), or resolves without one; its
    # lanes equal the whole run's
    leg = sim.launch_leg(seeds=[7, 8], defer=True)
    assert not leg.started and not leg.is_ready()
    leg.start()
    assert leg.started and leg.is_ready()
    done = leg.resolve()
    assert leg.resolve() is done and done.done
    assert done.wall_seconds == pytest.approx(
        done.pack_seconds + done.device_seconds + done.fetch_seconds,
        rel=1e-6)
    assert [ck.wall_seconds for ck in done.checkpoints] == \
        [done.wall_seconds] * 2
    for i in range(2):
        _overlay_equal(done.results().lanes[i], ref.lanes[i], f"leg lane {i}")
    dleg = dsim.launch_leg(seeds=[5, 6], defer=True)
    assert not dleg.started
    _dense_equal(dleg.resolve().results().lanes[0],
                 Simulation(dcfg.replace(seed=5), device="cpu").run(),
                 "deferred dense leg lane 0")
    # reseeded fleets of one shape reuse the cached run closure
    built = run_build_count()
    dsim.run_bench(seeds=[1, 2], warmup=False)
    fleet.FleetSimulation(dcfg, device="cpu").run_bench(seeds=[3, 4],
                                                        warmup=False)
    assert run_build_count() == built
    assert dsim.evict_programs() >= 1
    dsim.run_bench(seeds=[1, 2], warmup=False)
    assert run_build_count() == built + 1


@pytest.mark.parametrize("model", ["dense", "overlay"])
def test_legs_cross_packages_with_equal_digests(model):
    """A lane cut in one package resumes in the other and finishes equal
    to the uninterrupted run; both packages' digests agree on the cut."""
    from gossip_protocol_tpu.models.segments import checkpoint_ticks
    if model == "dense":
        kw = dict(max_nnb=16, single_failure=False, drop_msg=True,
                  msg_drop_prob=0.1, seed=0, total_ticks=60, fail_tick=30,
                  rejoin_after=15, drop_open_tick=10, drop_close_tick=50)
    else:
        kw = dict(max_nnb=64, model="overlay", single_failure=False,
                  drop_msg=True, msg_drop_prob=0.1, seed=0, total_ticks=96,
                  churn_rate=0.2, rejoin_after=30, step_rate=12 / 64,
                  drop_open_tick=32, drop_close_tick=64)
    cfg, jcfg = _both(kw)
    seeds = [1, 2]
    sim = fleet.FleetSimulation(cfg, device="cpu")
    jsim = jax_fleet.FleetSimulation(jcfg)
    full = sim.run(seeds=seeds, warmup=False)
    cut = checkpoint_ticks(jcfg)[len(checkpoint_ticks(jcfg)) // 2]
    mine = sim.run_leg(seeds=seeds, ticks=cut).checkpoints
    theirs = jsim.run_leg(seeds=seeds, ticks=cut).checkpoints
    for a, b in zip(mine, theirs):
        assert a.tick == b.tick == cut
        for k in b.state:
            _eq(a.state[k], b.state[k], f"cut state {k}")
        assert a.cfg.to_dict() == b.cfg.to_dict()
        assert a.digest() == b.digest()
    # port cut -> JAX finish, and JAX cut -> port finish
    to_jax = [jax_fleet.checkpoint_from_arrays(*fleet.checkpoint_arrays(c))
              for c in mine]
    to_port = [fleet.checkpoint_from_arrays(*jax_fleet.checkpoint_arrays(c))
               for c in theirs]
    assert [c.digest() for c in to_port] == [c.digest() for c in mine]
    done_jax = jsim.run_leg(resume=to_jax).results()
    done_port = sim.run_leg(resume=to_port).results()
    for i in range(len(seeds)):
        if model == "dense":
            _dense_equal(done_port.lanes[i], full.lanes[i], f"port {i}")
            _dense_equal(done_jax.lanes[i], full.lanes[i], f"jax {i}")
        else:
            _overlay_equal(done_port.lanes[i], full.lanes[i], f"port {i}")
            _overlay_equal(done_jax.lanes[i], full.lanes[i], f"jax {i}")
    with pytest.raises(ValueError, match="segment cut"):
        sim.run_leg(seeds=seeds, ticks=cut + 1)


def test_stack_lanes_variants_agree():
    from gossip_protocol_tpu_torch.state import make_schedule, \
        make_schedule_host
    cfgs = [SimConfig(**_world(seed=s, partition_groups=2,
                               partition_open_tick=30,
                               partition_close_tick=70)) for s in (1, 2, 3)]
    dev = fleet.stack_lanes([make_schedule(c, "cpu") for c in cfgs])
    host = fleet.stack_lanes_host([make_schedule_host(c) for c in cfgs])
    for f in dataclasses.fields(dev):
        a, b = _np(getattr(dev, f.name)), _np(getattr(host, f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    with pytest.raises(ValueError, match="lane 1 field .in_group"):
        from gossip_protocol_tpu_torch.state import init_state
        fleet.stack_lanes([init_state(cfgs[0], "cpu"),
                           init_state(SimConfig(max_nnb=8), "cpu")])


def _lane_inputs(b, n, seed):
    """B lanes of merge/epilogue inputs from different seeds, the number
    of delivering senders differing lane to lane (lane 0 silent)."""
    rng = np.random.default_rng(seed)
    lanes = []
    for i in range(b):
        p = [0.0, 0.05, 0.6, 1.0][i % 4]
        x = dict(gossip=rng.random((n, n)) < p, proc=rng.random(n) < 0.9,
                 known=rng.random((n, n)) < 0.7,
                 hb=rng.integers(0, 400, (n, n), dtype=np.int32),
                 ts=rng.integers(260, 301, (n, n), dtype=np.int32),
                 gdrop=rng.random((n, n)) < 0.1, ops=rng.random(n) < 0.85,
                 jrep=rng.random(n) < 0.2, jreq=rng.random(n) < 0.2,
                 hold=rng.random(n) < 0.1)
        lanes.append(x)
    return {k: torch.from_numpy(np.stack([x[k] for x in lanes]))
            for k in lanes[0]}


@pytest.mark.parametrize("b,n", [(3, 10), (4, 64)])
def test_lane_axis_plain_kernels(b, n):
    """The lane-axis ``masked_max3`` and ``tick_epilogue`` (their plain
    versions, as the CPU wrappers run them) equal their per-lane calls
    and the JAX merge, lane by lane, without a launch."""
    now, t_remove = 300, 20
    x = _lane_inputs(b, n, seed=n)
    before = (merge.masked_max3.launches, tick_epilogue.launches)
    m = merge.masked_max3(x["gossip"], x["proc"], x["known"], x["hb"],
                          x["ts"], now, t_remove=t_remove)
    out = tick_epilogue(*m, x["gossip"], x["proc"], x["known"], x["hb"],
                        x["ts"], x["gdrop"], x["ops"], x["jrep"], x["jreq"],
                        x["hold"], now, t_remove=t_remove,
                        rows=(torch.zeros(x["ops"].shape, dtype=torch.int32),
                              torch.zeros(x["ops"].shape, dtype=torch.int32)))
    assert (merge.masked_max3.launches, tick_epilogue.launches) == before
    for i in range(b):
        recv_from = (x["gossip"][i] & x["proc"][i][None, :]).T.numpy()
        want = jax_merge.gossip_reductions(
            recv_from, x["known"][i].numpy(), x["hb"][i].numpy(),
            x["ts"][i].numpy(), np.int32(now), t_remove=t_remove)
        for a, w in zip(m, want[:3]):
            _eq(a[i], w, f"merge lane {i}")
        solo = tick_epilogue_plain(
            *(v[i] for v in m), *(x[k][i] for k in (
                "gossip", "proc", "known", "hb", "ts", "gdrop", "ops",
                "jrep", "jreq", "hold")), now, t_remove=t_remove)
        for a, w in zip(out, solo):
            _eq(a[i], w, f"epilogue lane {i}")


@pytest.mark.parametrize("case", ["grader", "embedded", "thresholds_groups"])
def test_lane_axis_plain_drop(case):
    """The lane-axis draw equals each lane's solo draw and the JAX draw:
    B=3 N=10 with one lane's window open, an embedded narrower draw, and
    per-lane thresholds with partition groups."""
    rng = np.random.default_rng(7)
    n, t = {"grader": (10, 60), "embedded": (64, 30),
            "thresholds_groups": (32, 45)}[case]
    seeds = [11, 12, 13]
    na = 40 if case == "embedded" else n
    active = np.zeros((3, 100), bool)
    if case == "grader":
        active[2, 50:] = True
    else:
        active[:, :] = True
    prob = np.float32([0.1, 0.2, 0.3])
    link = group = part = None
    if case == "thresholds_groups":
        link = torch.from_numpy(rng.random((3, n, n)).astype(np.float32))
        group = torch.from_numpy(rng.integers(0, 3, (3, n), dtype=np.int32))
        part = np.zeros((3, 100), bool)
        part[1:, 40:] = True
    plan = LaneDrop(np.stack([prng_key(s) for s in seeds]), prob, active,
                    part)
    before = drop_masks_lanes.launches
    g, q, p = drop_masks_lanes(plan, t, n, na, device="cpu", link_prob=link,
                               group=group)
    assert drop_masks_lanes.launches == before
    assert g.shape == (3, n, n) and q.shape == p.shape == (3, n)
    for i, s in enumerate(seeds):
        solo = tick_drop_masks(prng_key(s), t, n, bool(active[i, t]),
                               prob[i], "cpu",
                               link_prob=None if link is None else link[i],
                               n_active=na,
                               group=None if group is None else group[i],
                               part_active=part is not None and part[i, t])
        for a, w in zip((g, q, p), solo):
            _eq(a[i], w, f"lane {i}")
        if case != "embedded" and not (part is not None and part[i, t]):
            import jax
            want = jax_drop_masks(
                jax.random.PRNGKey(s), t, n, bool(active[i, t]), prob[i],
                link_prob=None if link is None else link[i].numpy())
            for a, w in zip((g, q, p), want):
                _eq(a[i], w, f"lane {i} vs JAX")
    if case == "grader":
        assert not g[:2].any() and g[2].any()


def test_sparse_staging_is_byte_identical():
    """Simulation.run's sparse event staging equals the masks it stages,
    at a size where the cap overflows into the dense copy too."""
    from gossip_protocol_tpu_torch.core.sim import _masks_to_host
    g = torch.Generator().manual_seed(3)
    for c, n in ((4, 10), (3, 33), (2, 64)):
        a = torch.rand((c, n, n), generator=g) < 0.02
        r = torch.rand((c, n, n), generator=g) < 0.5
        for cap in (1 << 14, 5):
            ah, rh = _masks_to_host(a, r, cap)
            assert np.array_equal(ah, a.numpy())
            assert np.array_equal(rh, r.numpy())
