"""The CUDA kernels against their plain versions, on an H100.

Run from the repository root on a machine with an sm_90 card (the
kernels are built from ``gossip_protocol_tpu_torch/csrc/`` at first
use); ``--noconftest`` skips ``tests/conftest.py``, which imports JAX,
and a GPU host running the port need not have JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Elsewhere every test here skips: a CUDA kernel has no CPU mode, and its
arithmetic is held against the JAX package on the CPU through the plain
versions (tests/test_torch_tickfused.py, tests/test_torch_dense_mega.py,
tests/test_torch_overlay_exchange.py, tests/test_torch_overlay_mega.py).
Every comparison is exact: all state is integer or boolean.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

T = 300
T_REMOVE = 20


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90); none is visible")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _k1_inputs(n, case, seed, dev):
    """One merge case (tests/test_torch_merge_cases.py) and random
    epilogue lanes, on the card."""
    from test_torch_merge_cases import merge_case
    rng = np.random.default_rng(seed + 1)

    def b(p, shape):
        return torch.from_numpy(rng.random(shape) < p).to(dev)

    merge_in = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in merge_case(case, n, seed))
    return merge_in, dict(
        gdrop=b(0.1, (n, n)), ops=b(0.85, n), jrep=b(0.2, n),
        jreq=b(0.2, n), live_hold=b(0.1, n))


def _check_k1(gossip, proc, known, hb, ts, v, t):
    """Both kernels equal their plain versions on one input, the
    epilogue with and without events; each wrapper counts its launch."""
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import (
        tick_epilogue, tick_epilogue_plain)
    from gossip_protocol_tpu_torch.ops.merge import (masked_max3,
                                                     masked_max3_plain)
    before = masked_max3.launches
    m = masked_max3(gossip, proc, known, hb, ts, t, t_remove=T_REMOVE)
    assert masked_max3.launches == before + 1
    m_p = masked_max3_plain(gossip, proc, known, hb, ts, t,
                            t_remove=T_REMOVE)
    torch.cuda.synchronize()
    for a, b in zip(m, m_p):
        assert torch.equal(a, b)
    for ev in (True, False):
        args = (*m, gossip, proc, known, hb, ts, v["gdrop"], v["ops"],
                v["jrep"], v["jreq"], v["live_hold"], t)
        before = tick_epilogue.launches
        got = tick_epilogue(*args, t_remove=T_REMOVE, with_events=ev)
        assert tick_epilogue.launches == before + 1
        want = tick_epilogue_plain(*args, t_remove=T_REMOVE, with_events=ev)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("n,case", [
    (10, 0.6), (64, 0.6), (100, 0.6), (333, 0.6), (1024, 0.6),
    (64, "empty"), (64, "single_sender"), (100, "distinct"),
    (100, "fresh_spread"), (333, "no_fresh_cols"), (1024, "sparse_senders"),
    (333, "distinct")])
def test_masked_max3_and_epilogue_kernels(dev, n, case):
    (gossip, proc, known, hb, ts), v = _k1_inputs(n, case, n, dev)
    _check_k1(gossip, proc, known, hb, ts, v, T)


def test_kernels_on_a_real_tick_state(dev):
    """Both kernels on the input of tick 699 of the N=1024 multifailure
    10% drop run (the per-tick route stopped one tick early)."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.tick import make_tick_run
    from gossip_protocol_tpu_torch.ops.drop import tick_drop_masks
    from gossip_protocol_tpu_torch.ops.vector import vector_step
    from gossip_protocol_tpu_torch.state import init_state, make_schedule
    cfg = SimConfig(max_nnb=1024, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=0)
    t = cfg.total_ticks - 1
    st, sched = init_state(cfg, dev), make_schedule(cfg, dev)
    st, _ = make_tick_run(cfg.replace(total_ticks=t), with_events=False)(
        st, sched)
    gdrop, qdrop, pdrop = tick_drop_masks(st.rng, t, cfg.n, sched.drop_on(t),
                                          sched.drop_prob, dev)
    vs = vector_step(t, sched.start_tick, sched.fail_tick, sched.rejoin_tick,
                     st.in_group, st.own_hb, st.joinreq, st.joinrep, qdrop,
                     pdrop, churn=False)
    assert (st.gossip & vs.proc[None, :]).any()
    _check_k1(st.gossip, vs.proc, st.known, st.hb, st.ts,
              dict(gdrop=gdrop.contiguous(), ops=vs.ops, jrep=vs.jrep,
                   jreq=vs.jreq, live_hold=vs.hold), t)


def _k2_inputs(n, s_ticks, dev):
    """Random valid K2 inputs: a join ramp, failures and rejoins inside
    the launch (numpy seed ``n``)."""
    rng = np.random.default_rng(n)
    never = np.iinfo(np.int32).max
    t0 = 90
    start = (0.25 * np.arange(n) + 60).astype(np.int32)
    fail = np.full(n, never, np.int32)
    rejoin = np.full(n, never, np.int32)
    victims = rng.random(n) < 0.25
    fail[victims] = t0 + 1
    rejoin[victims] = t0 + 4
    aux = np.stack([rng.random(n) < 0.8, rng.integers(0, 90, n),
                    rng.random(n) < 0.3, rng.random(n) < 0.3, start, fail,
                    rejoin, np.zeros(n)], 1).astype(np.int32)
    host = dict(
        known=(rng.random((n, n)) < 0.7).astype(np.int32),
        hb=rng.integers(0, 90, (n, n), dtype=np.int32),
        ts=rng.integers(t0 - 40, t0 + 1, (n, n), dtype=np.int32),
        gossip=(rng.random((n, n)) < 0.6).astype(np.int32), aux=aux,
        gdrop=rng.random((s_ticks, n, n)) < 0.1,
        qdrop=rng.random((s_ticks, n)) < 0.2,
        pdrop=rng.random((s_ticks, n)) < 0.2)
    x = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    return dict(x, sp=t0)


def _check_k2(x, **kw):
    """K2 (one launch) equals its plain version, with and without events
    and churn."""
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import (
        dense_mega_ticks, dense_mega_ticks_plain)
    grid = kw.pop("grid_blocks", None)
    for ev, rj in ((True, True), (False, False)):
        before = dense_mega_ticks.launches
        got = dense_mega_ticks(**x, **kw, can_rejoin=rj, with_events=ev,
                               grid_blocks=grid)
        assert dense_mega_ticks.launches == before + 1
        want = dense_mega_ticks_plain(**x, **kw, can_rejoin=rj,
                                      with_events=ev)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n,s_ticks", ((16, 16), (64, 16), (200, 8),
                                       (1024, 8)))
def test_dense_mega_kernel(dev, n, s_ticks):
    _check_k2(_k2_inputs(n, s_ticks, dev), n=n, s_ticks=s_ticks,
              t_remove=T_REMOVE)


@pytest.mark.parametrize("n,s_ticks,blocks", ((64, 16, 1), (200, 7, 1),
                                              (200, 8, 5)))
def test_dense_mega_kernel_grid_sizes(dev, n, s_ticks, blocks):
    """K2's persistent grid at a size of the caller's: one block, or a
    few, taking every tile of each phase in turn; an odd S."""
    _check_k2(_k2_inputs(n, s_ticks, dev), n=n, s_ticks=s_ticks,
              t_remove=T_REMOVE, grid_blocks=blocks)


@pytest.mark.parametrize("embedded", (False, True))
@pytest.mark.parametrize("s_ticks", (1, 8, 16))
@pytest.mark.parametrize("n", (10, 64, 896, 2816))
def test_drop_masks_kernel(dev, n, s_ticks, embedded):
    """The drop draw kernel against its plain version (utils/threefry.py
    in torch) on the card: one launch for S ticks, the window closed at
    every fourth tick of the launch, the draw at full width or embedded
    at 3/4 of it."""
    from gossip_protocol_tpu_torch.ops.drop import drop_masks, drop_masks_plain
    from gossip_protocol_tpu_torch.utils.threefry import prng_key
    na = n * 3 // 4 if embedded else n
    active = [s_ticks == 1 or s % 4 != 0 for s in range(s_ticks)]
    for prob in (0.1, 0.25):
        before = drop_masks.launches
        got = drop_masks(prng_key(n), 100, active, np.float32(prob), n,
                         n_active=na, device=dev)
        assert drop_masks.launches == before + 1
        want = drop_masks_plain(prng_key(n), 100, active, np.float32(prob),
                                n, na, dev)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert got[0].any()


@pytest.mark.parametrize("worlds", ("thresholds", "groups", "both"))
@pytest.mark.parametrize("s_ticks", (1, 8))
@pytest.mark.parametrize("n", (10, 64, 1024, 4096))
def test_drop_masks_kernel_worlds(dev, n, s_ticks, worlds):
    """The draw kernel with the asym world's per-link thresholds, the
    partition's groups, or both, against its plain version: in one
    launch of 8 ticks the drop window and the partition are each open
    and closed, in all four combinations."""
    from gossip_protocol_tpu_torch.ops.drop import drop_masks, drop_masks_plain
    from gossip_protocol_tpu_torch.utils.threefry import prng_key
    rng = np.random.default_rng(n)
    lp = torch.from_numpy((rng.random((n, n)) * 0.3).astype(np.float32)) \
        .to(dev) if worlds != "groups" else None
    grp = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev) \
        if worlds != "thresholds" else None
    active = [True, False, True, False, True, True, False, False][:s_ticks]
    part = [True, True, False, False, True, False, True, False][:s_ticks]
    if s_ticks == 1:
        # thresholds alone: the window open; with groups: the window
        # closed and the partition open (the gate alone)
        active, part = [grp is None], [True]
    before = drop_masks.launches
    got = drop_masks(prng_key(n), 100, active, np.float32(0.1), n,
                     device=dev, link_prob=lp, group=grp,
                     part_active=part if grp is not None else None)
    assert drop_masks.launches == before + 1
    want = drop_masks_plain(prng_key(n), 100, active, np.float32(0.1), n,
                            device=dev, link_prob=lp, group=grp,
                            part_active=part if grp is not None else None)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].any() or got[1].any()


#: one world config per route: (model, config, kernels that must launch,
#: kernels that must not)
WORLD_ROUTES = {
    "dense_asym": ("dense", dict(max_nnb=64, drop_msg=True,
                                 msg_drop_prob=0.12, asym_drop=True,
                                 drop_open_tick=10, drop_close_tick=90,
                                 partition_groups=2,
                                 partition_open_tick=30,
                                 partition_close_tick=42),
                   ("drop_masks", "masked_max3", "tick_epilogue"),
                   ("dense_mega_ticks",)),
    "dense_wave": ("dense", dict(max_nnb=64, single_failure=False,
                                 wave_size=6, wave_tick=40, wave_speed=2),
                   ("drop_masks", "dense_mega_ticks"),
                   ("masked_max3", "tick_epilogue")),
    "dense_byz_latency": ("dense", dict(max_nnb=32, byz_rate=0.2,
                                        byz_boost=8, link_latency=4,
                                        zombie=True),
                          ("drop_masks", "masked_max3"),
                          ("tick_epilogue", "dense_mega_ticks")),
    "overlay_gauntlet": ("overlay", dict(
        model="overlay", max_nnb=64, single_failure=False, wave_size=12,
        wave_tick=48, wave_speed=2, partition_groups=2,
        partition_open_tick=44, partition_close_tick=56, flap_rate=0.2,
        flap_period=24, flap_down=6, flap_open_tick=64,
        flap_close_tick=128, link_latency=3, byz_rate=0.1, byz_boost=4,
        drop_msg=True, msg_drop_prob=0.06, asym_drop=True,
        step_rate=8.0 / 64), (),
        ("fused_overlay_tick", "mega_overlay_ticks", "grid_overlay_ticks")),
}


@pytest.mark.parametrize("name", sorted(WORLD_ROUTES))
def test_world_routes_cuda_equals_cpu(dev, name):
    """One world config per route on the card equals its CPU run (dense:
    events, counters and final state; overlay: state and metrics), and
    the launch counters show the route."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.sim import Simulation
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import \
        dense_mega_ticks
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import \
        fused_overlay_tick
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import \
        grid_overlay_ticks
    from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import \
        mega_overlay_ticks
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import tick_epilogue
    from gossip_protocol_tpu_torch.ops.drop import drop_masks
    from gossip_protocol_tpu_torch.ops.merge import masked_max3
    fns = {f.__name__: f for f in (
        drop_masks, masked_max3, tick_epilogue, dense_mega_ticks,
        fused_overlay_tick, mega_overlay_ticks, grid_overlay_ticks)}
    model, kw, used, unused = WORLD_ROUTES[name]
    cfg = SimConfig(seed=3, total_ticks=140, **kw)
    before = {k: f.launches for k, f in fns.items()}
    if model == "dense":
        a = Simulation(cfg, device="cuda").run()
        after = {k: f.launches for k, f in fns.items()}
        b = Simulation(cfg, device="cpu").run()
        for f in ("added", "removed", "sent", "recv"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        fields = ("known", "hb", "ts", "gossip", "gossip_age", "in_group")
    else:
        a = OverlaySimulation(cfg, device="cuda").run()
        after = {k: f.launches for k, f in fns.items()}
        b = OverlaySimulation(cfg, device="cpu").run()
        for f in vars(a.metrics):
            assert np.array_equal(getattr(a.metrics, f),
                                  getattr(b.metrics, f)), f
        fields = ("ids", "hb", "ts", "send_hist", "send_flags", "in_group")
    for f in fields:
        assert torch.equal(getattr(a.final_state, f).cpu(),
                           getattr(b.final_state, f)), f
    for k in used:
        assert after[k] > before[k], (k, after)
    for k in unused:
        assert after[k] == before[k], (k, after)


def test_cooperative_launch_too_large_raises(dev):
    """A persistent grid larger than the card holds at once is refused by
    the runtime, and the wrappers raise (no fallback); the card stays
    usable."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_mega as pmega
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import dense_mega_ticks
    from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import \
        mega_overlay_ticks
    x = _k2_inputs(64, 2, dev)
    with pytest.raises(RuntimeError, match="dense_mega_ticks: CUDA error"):
        dense_mega_ticks(**x, n=64, s_ticks=2, t_remove=T_REMOVE,
                         can_rejoin=False, grid_blocks=10 ** 6)
    cfg = _overlay_cfg("drop128")
    sched = pov.make_overlay_schedule(cfg)
    state = pov.init_overlay_state(cfg, dev)
    f = pov.resolved_dims(cfg)[1]
    sp = pmega._sp_vector(cfg, sched, 0, 4, cfg.n, f)
    with pytest.raises(RuntimeError, match="mega_overlay_ticks: CUDA error"):
        mega_overlay_ticks(pmega._pack_state(cfg, state, sched), sp,
                           s_ticks=4, grid_blocks=10 ** 6,
                           **pmega.mega_kernel_kwargs(cfg, sched))
    _check_k2(x, n=64, s_ticks=2, t_remove=T_REMOVE)


@pytest.mark.parametrize("kw", [dict(max_nnb=10),
                                dict(max_nnb=64, single_failure=False),
                                dict(max_nnb=48, drop_msg=True,
                                     rejoin_after=30)])
def test_simulation_cuda_equals_cpu(dev, kw):
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.sim import Simulation
    cfg = SimConfig(seed=2, total_ticks=200, **kw)
    a = Simulation(cfg, device="cuda").run()
    b = Simulation(cfg, device="cpu").run()
    for name in ("added", "removed", "sent", "recv"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.final_state.hb.cpu(), b.final_state.hb)


OVERLAY = {
    "churn64": dict(max_nnb=64, single_failure=False, seed=7,
                    total_ticks=200, churn_rate=0.25, rejoin_after=30,
                    step_rate=40.0 / 64),
    "drop128": dict(max_nnb=128, single_failure=True, drop_msg=True,
                    msg_drop_prob=0.3, seed=5, total_ticks=120, fail_tick=60,
                    step_rate=0.25, drop_open_tick=10, drop_close_tick=100),
    # F=8: outside K4's envelope, so K3 per tick
    "powerlaw64_f8": dict(max_nnb=64, single_failure=True, seed=6,
                          total_ticks=100, fail_tick=40, topology="powerlaw",
                          drop_msg=True, msg_drop_prob=0.1,
                          drop_open_tick=20, drop_close_tick=80),
}


@pytest.mark.parametrize("name", sorted(OVERLAY))
def test_overlay_kernels_equal_plain(dev, name):
    """K3 and K4 against their plain versions on the card, on the inputs
    a run gives them at tick 60 (mid-churn, inside the drop window)."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_mega as pmega
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
        fused_overlay_tick, fused_overlay_tick_plain)
    from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import (
        mega_overlay_ticks, mega_overlay_ticks_plain)
    cfg = SimConfig(model="overlay", **OVERLAY[name])
    sched = pov.make_overlay_schedule(cfg)
    state = pov.OverlaySimulation(cfg, device="cuda").run(
        ticks=60).final_state
    got = {}

    def keep(*args, **kw):
        got.update(args=args, kw=kw)
        return fused_overlay_tick(*args, **kw)

    pov.make_overlay_tick(cfg, exchange=keep)(state, sched)
    before = fused_overlay_tick.launches
    a = fused_overlay_tick(*got["args"], **got["kw"])
    assert fused_overlay_tick.launches == before + 1
    b = fused_overlay_tick_plain(*got["args"], **got["kw"])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    if not pmega.mega_supported(cfg):
        return
    f = pov.resolved_dims(cfg)[1]
    st = pmega._pack_state(cfg, state, sched)
    kw = pmega.mega_kernel_kwargs(cfg, sched)
    for s_ticks in (16, 5):
        sp = pmega._sp_vector(cfg, sched, state.tick, s_ticks, cfg.n, f)
        a = mega_overlay_ticks(st, sp, s_ticks=s_ticks, **kw)
        b = mega_overlay_ticks_plain(st, sp, s_ticks=s_ticks, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _overlay_cfg(name):
    from gossip_protocol_tpu_torch.config import SimConfig
    return SimConfig(model="overlay", **OVERLAY[name])


@pytest.mark.parametrize("s_ticks,blocks", ((12, None), (16, 1), (16, 7)))
def test_mega_overlay_remainder_and_grid_sizes(dev, s_ticks, blocks):
    """K4 at N=4096 (the BASELINE drop run's shape) on the real tick-96
    state: a 12-tick remainder launch, and whole launches on a one-block
    and a seven-block persistent grid, each equal to its plain version."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_mega as pmega
    from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import (
        mega_overlay_ticks, mega_overlay_ticks_plain)
    cfg = SimConfig(model="overlay", max_nnb=4096, single_failure=True,
                    drop_msg=True, msg_drop_prob=0.1, total_ticks=608,
                    fail_tick=304, step_rate=40.0 / 4096, seed=0)
    sched = pov.make_overlay_schedule(cfg)
    state = pov.OverlaySimulation(cfg, device="cuda").run(
        ticks=96).final_state
    f = pov.resolved_dims(cfg)[1]
    st = pmega._pack_state(cfg, state, sched)
    kw = pmega.mega_kernel_kwargs(cfg, sched)
    sp = pmega._sp_vector(cfg, sched, state.tick, s_ticks, cfg.n, f)
    before = mega_overlay_ticks.launches
    a = mega_overlay_ticks(st, sp, s_ticks=s_ticks, grid_blocks=blocks, **kw)
    assert mega_overlay_ticks.launches == before + 1
    b = mega_overlay_ticks_plain(st, sp, s_ticks=s_ticks, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[1][:, 7].sum()) > 0       # merges were received


@pytest.mark.parametrize("name", sorted(OVERLAY))
def test_overlay_simulation_cuda_equals_cpu(dev, name):
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.models import overlay as pov
    cfg = SimConfig(model="overlay", **OVERLAY[name])
    a = pov.OverlaySimulation(cfg, device="cuda").run()
    b = pov.OverlaySimulation(cfg, device="cpu").run()
    for f in ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
              "joinreq", "joinrep"):
        assert torch.equal(getattr(a.final_state, f).cpu(),
                           getattr(b.final_state, f)), f
    for f in pov.METRIC_FIELDS:
        assert np.array_equal(getattr(a.metrics, f),
                              getattr(b.metrics, f)), f


# ---- K5 (grid_overlay_ticks) -------------------------------------------

GRID = {
    # BASELINE's two grid configs with their windows kept at small N
    # (start ramp 64 / 40 ticks, churn 152-495, fail 136): their plans
    # give every flag combination the full-size runs use
    "churn": dict(single_failure=False, total_ticks=608, churn_rate=0.2,
                  rejoin_after=40),
    "powerlaw": dict(single_failure=True, total_ticks=272, fail_tick=136,
                     topology="powerlaw"),
}


def _grid_cfg(name, n):
    from gossip_protocol_tpu_torch.config import SimConfig
    step = 64.0 / n if name == "churn" else 40.0 / n
    return SimConfig(model="overlay", max_nnb=n, seed=1, step_rate=step,
                     **GRID[name])


def _random_state(cfg, t, seed, dev, join=True):
    """A random valid overlay state at tick t; without ``join`` the
    in-flight join bits are zero (a join-dead launch's guarantee)."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.ops.overlay_rules import OverlayState
    rng = np.random.default_rng(seed)
    n = cfg.n
    k, f = pov.resolved_dims(cfg)
    ids = rng.integers(0, n, (n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.3] = -1
    occ = ids >= 0
    hb = np.where(occ, rng.integers(0, 300, (n, k)), 0).astype(np.int32)
    ts = np.where(occ, rng.integers(max(t - 25, 0), max(t, 1), (n, k)),
                  0).astype(np.int32)
    jr = (rng.random((2, n)) < 0.05) & join

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return OverlayState(
        tick=t, ids=t_(ids), hb=t_(hb), ts=t_(ts),
        in_group=t_(rng.random(n) < 0.9),
        own_hb=t_(rng.integers(0, 300, n).astype(np.int32)),
        send_flags=t_(rng.random((n, f)) < 0.8),
        send_hist=t_(np.zeros((n, f), np.int32)), joinreq=t_(jr[0]),
        joinrep=t_(jr[1]))


def _k5_cases(cfg):
    """(t0, s_ticks, flags) launches to check: one of each flag
    combination of the tick-0 plan, an all-live launch off the slot-epoch
    grid (t0 = 17) and a 12-tick remainder."""
    from gossip_protocol_tpu_torch.models.segments import (ALL_LIVE,
                                                           plan_segments)
    seen = {}
    for seg in plan_segments(cfg, cfg.total_ticks, 0, 16):
        seen.setdefault(seg.flags, seg.start)
    cases = [(t0, 16, fl) for fl, t0 in seen.items()]
    return cases + [(17, 16, ALL_LIVE), (170, 12, ALL_LIVE)]


@pytest.mark.parametrize("name", sorted(GRID))
@pytest.mark.parametrize("n", (64, 4096))
def test_grid_kernel_equals_plain(dev, name, n):
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_grid as pg
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import (
        grid_overlay_ticks, grid_overlay_ticks_plain)
    cfg = _grid_cfg(name, n)
    sched = pov.make_overlay_schedule(cfg)
    k, f = pov.resolved_dims(cfg)
    kw = pg.grid_kernel_kwargs(cfg, k, f)
    cases = _k5_cases(cfg)
    assert len({c[2] for c in cases}) >= 3
    for i, (t0, s_ticks, flags) in enumerate(cases):
        state = _random_state(cfg, t0, n + i, dev, join=flags.join_live)
        plane = pg.pack_grid_plane(cfg, state)
        _, sp = pg.grid_launch_input(cfg, sched, plane, t0, s_ticks)
        before = grid_overlay_ticks.launches
        a = grid_overlay_ticks(plane, sp, s_ticks=s_ticks, **kw,
                               **flags.as_kernel_kwargs())
        assert grid_overlay_ticks.launches == before + 1
        b = grid_overlay_ticks_plain(plane, sp, s_ticks=s_ticks, **kw,
                                     **flags.as_kernel_kwargs())
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y), (t0, s_ticks, flags)


def test_grid_fleet_kernel_equals_plain(dev):
    """A B=2 launch: each lane its own seed and state, the lanes' planes
    at a stride of two planes (as a fleet's phase of ``plane2``)."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_grid as pg
    from gossip_protocol_tpu_torch.models.segments import ALL_LIVE
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import (
        grid_overlay_ticks, grid_overlay_ticks_plain)
    cfg = _grid_cfg("churn", 64)
    k, f = pov.resolved_dims(cfg)
    planes = torch.stack([torch.stack([
        pg.pack_grid_plane(cfg, _random_state(cfg, 160, s, dev))] * 2)
        for s in (3, 4)])[:, 1]
    assert planes.stride(0) == 2 * planes[0].numel()
    lanes = [pg.grid_launch_input(
        cfg, pov.make_overlay_schedule(cfg.replace(seed=s)), planes[b], 160,
        16) for b, s in enumerate((3, 4))]
    sp = np.stack([x[1] for x in lanes])
    kw = dict(pg.grid_kernel_kwargs(cfg, k, f), s_ticks=16, batch=2,
              **ALL_LIVE.as_kernel_kwargs())
    a = grid_overlay_ticks(planes, sp, **kw)
    b = grid_overlay_ticks_plain(planes, sp, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_grid_route_equals_k3_route_and_cpu(dev):
    """N=8192 churn, 64 ticks: the K5 route equals the per-tick K3 route
    and the same K5 route on the CPU; a B=2 fleet equals its solo runs."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_grid as pg
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import \
        fused_overlay_tick
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import \
        grid_overlay_ticks
    cfg = _grid_cfg("churn", 8192).replace(total_ticks=256)
    sched = pov.make_overlay_schedule(cfg)
    fields = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
              "joinreq", "joinrep")
    metrics = ("in_group", "view_slots", "adds", "removals",
               "false_removals", "victim_slots", "sent", "recv")
    before = (grid_overlay_ticks.launches, fused_overlay_tick.launches)
    g = pov.make_overlay_run(cfg, 64, start_tick=0)(
        pov.init_overlay_state(cfg, dev), sched)
    assert grid_overlay_ticks.launches == before[0] + 4
    k3 = pov.make_overlay_run(cfg, 64, grid=False)(
        pov.init_overlay_state(cfg, dev), sched)
    assert fused_overlay_tick.launches == before[1] + 64
    cpu = pov.make_overlay_run(cfg, 64, start_tick=0)(
        pov.init_overlay_state(cfg, "cpu"), sched)
    for other in (k3, cpu):
        for f in fields:
            assert torch.equal(getattr(g[0], f).cpu(),
                               getattr(other[0], f).cpu()), f
        for f in metrics:
            assert torch.equal(getattr(g[1], f).cpu(),
                               getattr(other[1], f).cpu()), f
    scheds = [pov.make_overlay_schedule(cfg.replace(seed=s)) for s in (5, 6)]
    fleet = pg.make_grid_fleet_run(cfg, 40, 2)(
        pg.stack_states([pov.init_overlay_state(cfg, dev)] * 2), scheds)
    for b, sc in enumerate(scheds):
        solo = pg.make_grid_run(cfg, 40, start_tick=0)(
            pov.init_overlay_state(cfg, dev), sc)
        lane = pg.lane_state(fleet[0], b)
        for f in fields:
            assert torch.equal(getattr(lane, f), getattr(solo[0], f)), f
        for f in metrics:
            assert torch.equal(getattr(fleet[1], f)[b],
                               getattr(solo[1], f)), f


def test_grid_kernel_rejects_bad_input(dev):
    """An XOR mask outside [1, N), a short ``sp`` row, a wrong plane
    shape, a fleet plane of the wrong lane count or a plane whose rows
    are not contiguous raises before any pointer reaches the kernel."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_grid as pg
    from gossip_protocol_tpu_torch.models.segments import ALL_LIVE
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import \
        grid_overlay_ticks
    cfg = _grid_cfg("churn", 64)
    k, f = pov.resolved_dims(cfg)
    plane = pg.pack_grid_plane(cfg, _random_state(cfg, 40, 1, dev))
    _, sp = pg.grid_launch_input(cfg, pov.make_overlay_schedule(cfg),
                                 plane, 40, 16)
    kw = dict(pg.grid_kernel_kwargs(cfg, k, f), s_ticks=16,
              **ALL_LIVE.as_kernel_kwargs())
    before = grid_overlay_ticks.launches
    bad = sp.copy()
    bad[-1] = cfg.n
    for args in ((plane, bad), (plane, sp[:-1]), (plane[:-1], sp),
                 (torch.stack([plane] * 2), sp),
                 (plane.T.contiguous().T, sp)):
        with pytest.raises(ValueError):
            grid_overlay_ticks(*args, **kw)
    assert grid_overlay_ticks.launches == before


def _grid_check(plane, boot, sp, kw):
    """K5 and its plain version on one launch input, bit for bit, and
    K5's boot pre-pass (one launch on a join-live launch, none on a
    join-dead one) against the plain ``boot``."""
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import (
        grid_boot_rows, grid_overlay_ticks, grid_overlay_ticks_plain)
    before = (grid_overlay_ticks.launches, grid_boot_rows.launches)
    a = grid_overlay_ticks(plane, sp, **kw)
    assert grid_overlay_ticks.launches == before[0] + 1
    assert grid_boot_rows.launches == before[1] + kw["join_live"]
    b = grid_overlay_ticks_plain(plane, sp, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(grid_boot_rows(
        plane, sp, n=kw["n"], k=kw["k"], batch=kw.get("batch", 1),
        join_live=kw["join_live"]), boot)


def test_grid_kernel_steady_state_powerlaw_f8(dev):
    """N=2^16 power-law (K=64, F=8): every row loop of the persistent grid
    runs many rows, on each flag variant of the plan, the boot block built
    on the card."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_grid as pg
    cfg = _grid_cfg("powerlaw", 1 << 16)
    sched = pov.make_overlay_schedule(cfg)
    k, f = pov.resolved_dims(cfg)
    assert (k, f) == (64, 8)
    cases = _k5_cases(cfg)
    assert {c[2].tag for c in cases} >= {"ramp+join", "steady", "churn"}
    for i, (t0, s_ticks, flags) in enumerate(cases):
        state = _random_state(cfg, t0, 90 + i, dev, join=flags.join_live)
        plane = pg.pack_grid_plane(cfg, state)
        boot, sp = pg.grid_launch_input(cfg, sched, plane, t0, s_ticks,
                                        flags.join_live)
        kw = dict(pg.grid_kernel_kwargs(cfg, k, f), s_ticks=s_ticks,
                  **flags.as_kernel_kwargs())
        _grid_check(plane, boot, sp, kw)


def test_grid_kernel_masks_below_a_block(dev):
    """XOR masks 1..7 put every partner beside its row (in its own warp
    block of rows, and in the same row pipeline's window)."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_grid as pg
    from gossip_protocol_tpu_torch.models.segments import ALL_LIVE
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import sp_len
    cfg = _grid_cfg("powerlaw", 4096)
    k, f = pov.resolved_dims(cfg)
    plane = pg.pack_grid_plane(cfg, _random_state(cfg, 150, 11, dev))
    boot, sp = pg.grid_launch_input(cfg, pov.make_overlay_schedule(cfg),
                                    plane, 150, 16)
    rng = np.random.default_rng(12)
    n_masks = 16 * f
    sp[sp_len(f, 16) - n_masks:] = rng.integers(1, 8, n_masks)
    kw = dict(pg.grid_kernel_kwargs(cfg, k, f), s_ticks=16,
              **ALL_LIVE.as_kernel_kwargs())
    _grid_check(plane, boot, sp, kw)


def test_grid_fleet_lanes_with_own_masks(dev):
    """A B=2 fleet at N=4096 whose lanes (seeds 7 and 8) have different
    masks, degrees and churn draws (and boot blocks)."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_grid as pg
    from gossip_protocol_tpu_torch.models.segments import ALL_LIVE
    cfg = _grid_cfg("churn", 4096)
    k, f = pov.resolved_dims(cfg)
    planes = torch.stack([pg.pack_grid_plane(
        cfg, _random_state(cfg, 200, s, dev)) for s in (7, 8)])
    lanes = [pg.grid_launch_input(
        cfg, pov.make_overlay_schedule(cfg.replace(seed=s)), planes[b], 200,
        16) for b, s in enumerate((7, 8))]
    sp = np.stack([x[1] for x in lanes])
    masks = sp[:, -16 * f:]
    assert (masks[0] != masks[1]).any()
    kw = dict(pg.grid_kernel_kwargs(cfg, k, f), s_ticks=16, batch=2,
              **ALL_LIVE.as_kernel_kwargs())
    _grid_check(planes, torch.stack([x[0] for x in lanes]), sp, kw)


def test_fused_overlay_tick_f8(dev):
    """K3 at F=8 (two chunks of partner loads) on a random N=65,536
    power-law state, against its plain version."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
        fused_overlay_tick, fused_overlay_tick_plain)
    cfg = _grid_cfg("powerlaw", 1 << 16)
    assert pov.resolved_dims(cfg)[1] == 8
    state = _random_state(cfg, 140, 5, dev)
    got = {}

    def keep(*args, **kw):
        got.update(args=args, kw=kw)
        return fused_overlay_tick_plain(*args, **kw)

    pov.make_overlay_tick(cfg, exchange=keep)(
        state, pov.make_overlay_schedule(cfg))
    a = fused_overlay_tick(*got["args"], **got["kw"])
    b = fused_overlay_tick_plain(*got["args"], **got["kw"])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", sorted(GRID))
@pytest.mark.parametrize("n", (64, 4096))
def test_grid_boot_prepass_equals_boot_rows(dev, name, n):
    """K5's boot pre-pass against the plain ``_boot_rows`` at join-live
    ticks (power-law seed 77 fails the introducer at tick 136, so ticks
    137 and 160 fall inside its fail window), solo and as a B=2 fleet of
    two seeds."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models import overlay_grid as pg
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import \
        grid_boot_rows
    cfg = _grid_cfg(name, n)
    k, _ = pov.resolved_dims(cfg)
    ticks = (1, 17, 40, 137, 160)
    for t0 in ticks:
        lanes = []
        for s in (77, 3):
            c = cfg.replace(seed=s)
            sched = pov.make_overlay_schedule(c)
            state = _random_state(c, t0, 31 * s + t0, dev)
            state.joinreq[:] = torch.rand(n, device=dev) < 0.3
            plane = pg.pack_grid_plane(c, state)
            lanes.append((plane, *pg.grid_launch_input(c, sched, plane, t0,
                                                       16)))
        before = grid_boot_rows.launches
        got = grid_boot_rows(lanes[0][0], lanes[0][2], n=n, k=k)
        assert grid_boot_rows.launches == before + 1
        assert torch.equal(got, lanes[0][1]), t0
        fleet = grid_boot_rows(torch.stack([x[0] for x in lanes]),
                               np.stack([x[2] for x in lanes]), n=n, k=k,
                               batch=2)
        assert torch.equal(fleet, torch.stack([x[1] for x in lanes])), t0
        dead = grid_boot_rows(lanes[0][0], lanes[0][2], n=n, k=k,
                              join_live=False)
        assert grid_boot_rows.launches == before + 2
        assert torch.equal(dead[0], lanes[0][1][0]) and not dead[1:].any()


@pytest.mark.parametrize("view,fanout", [(128, 16), (20, 1)])
def test_fused_overlay_tick_wide_and_narrow(dev, view, fanout):
    """K3 at the edges of its envelope, against its plain version: K=128
    with F=16 (four slots a lane, four chunks of partner loads) and K=20
    with F=1 (row lengths that are no multiple of four words)."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
        fused_overlay_tick, fused_overlay_tick_plain)
    cfg = _grid_cfg("churn", 4096).replace(overlay_view=view, fanout=fanout)
    assert pov.resolved_dims(cfg) == (view, fanout)
    state = _random_state(cfg, 200, view + fanout, dev)
    got = {}

    def keep(*args, **kw):
        got.update(args=args, kw=kw)
        return fused_overlay_tick_plain(*args, **kw)

    pov.make_overlay_tick(cfg, exchange=keep)(
        state, pov.make_overlay_schedule(cfg))
    a = fused_overlay_tick(*got["args"], **got["kw"])
    b = fused_overlay_tick_plain(*got["args"], **got["kw"])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- the fleet's lane axis --------------------------------------------

def _lane_k1(b, n, dev, seed=0):
    """B lanes of merge/epilogue inputs, each from its own seed; the
    number of delivering senders differs lane to lane (lane 0 silent)."""
    from test_torch_merge_cases import merge_case
    rng = np.random.default_rng(seed)
    lanes = []
    for i in range(b):
        case = (0.0, 0.05, 0.6, 1.0)[i % 4]
        g, p, kn, hb, ts = merge_case(case, n, seed + i)
        lanes.append(dict(
            gossip=g, proc=p, known=kn, hb=hb, ts=ts,
            gdrop=rng.random((n, n)) < 0.1, ops=rng.random(n) < 0.85,
            jrep=rng.random(n) < 0.2, jreq=rng.random(n) < 0.2,
            live_hold=rng.random(n) < 0.1))
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.stack([x[k] for x in lanes]))).to(dev) for k in lanes[0]}


@pytest.mark.parametrize("b,n", [(3, 10), (4, 64), (8, 512), (4, 2816)])
def test_lane_axis_k1_equals_plain(dev, b, n):
    """masked_max3 and tick_epilogue with a lane axis: one launch each for
    the B lanes, equal to the plain versions and to the solo kernel of
    each lane, with and without events."""
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import (
        tick_epilogue, tick_epilogue_lanes_plain)
    from gossip_protocol_tpu_torch.ops.merge import (masked_max3,
                                                     masked_max3_lanes_plain)
    x = _lane_k1(b, n, dev, seed=n)
    margs = (x["gossip"], x["proc"], x["known"], x["hb"], x["ts"], T)
    before = masked_max3.launches
    m = masked_max3(*margs, t_remove=T_REMOVE)
    assert masked_max3.launches == before + 1
    want = masked_max3_lanes_plain(*margs, t_remove=T_REMOVE)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(m, want))
    assert (m[0][0] == -1).all()            # the silent lane is all FILL
    for i in range(b):
        solo = masked_max3(*(a[i] for a in margs[:5]), T,
                           t_remove=T_REMOVE)
        assert all(torch.equal(a[i], s) for a, s in zip(m, solo))
    for ev in (True, False):
        args = (*m, x["gossip"], x["proc"], x["known"], x["hb"], x["ts"],
                x["gdrop"], x["ops"], x["jrep"], x["jreq"], x["live_hold"],
                T)
        before = tick_epilogue.launches
        got = tick_epilogue(*args, t_remove=T_REMOVE, with_events=ev)
        assert tick_epilogue.launches == before + 1
        want = tick_epilogue_lanes_plain(*args, t_remove=T_REMOVE,
                                         with_events=ev)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert (a is None and w is None) or torch.equal(a, w)


@pytest.mark.parametrize("case", ["b3_n10_one_open", "b4_n896_embedded",
                                  "b2_n4096_thresholds", "b2_n4096_groups"])
def test_lane_axis_drop_equals_plain(dev, case):
    from gossip_protocol_tpu_torch.ops.drop import (LaneDrop,
                                                    drop_masks_lanes,
                                                    drop_masks_lanes_plain)
    from gossip_protocol_tpu_torch.utils.threefry import prng_key
    b, n = {"b3_n10_one_open": (3, 10), "b4_n896_embedded": (4, 896)}.get(
        case, (2, 4096))
    rng = np.random.default_rng(b * n)
    na = 672 if case == "b4_n896_embedded" else n
    active = np.ones((b, 400), bool)
    if case == "b3_n10_one_open":
        active[:2] = False
    part = link = group = None
    if case == "b2_n4096_thresholds":
        link = torch.from_numpy(rng.random((b, n, n), np.float32) * 0.3) \
            .to(dev)
    if case == "b2_n4096_groups":
        group = torch.from_numpy(rng.integers(0, 3, (b, n), dtype=np.int32)
                                 ).to(dev)
        part = np.zeros((b, 400), bool)
        part[1] = True
    plan = LaneDrop(np.stack([prng_key(s) for s in range(b)]),
                    np.float32([0.1, 0.2, 0.3, 0.4][:b]), active, part)
    for t in (0, 300):
        before = drop_masks_lanes.launches
        got = drop_masks_lanes(plan, t, n, na, dev, link, group)
        assert drop_masks_lanes.launches == before + 1
        want = drop_masks_lanes_plain(plan, t, n, na, dev, link, group)
        torch.cuda.synchronize()
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        if case == "b3_n10_one_open":
            assert not got[0][:2].any() and got[0][2].any()


def test_lane_axis_refused_launch_raises(dev):
    """A launch the entry refuses (more lanes than a grid coordinate
    holds) raises; nothing falls back to a lane loop or the plain
    version."""
    from gossip_protocol_tpu_torch.ops.merge import masked_max3
    z = torch.zeros((21846, 1, 1), dtype=torch.bool, device=dev)
    zi = torch.zeros((21846, 1, 1), dtype=torch.int32, device=dev)
    before = masked_max3.launches
    with pytest.raises(RuntimeError, match="masked_max3: CUDA error"):
        masked_max3(z, z[:, 0], z, zi, zi, T, t_remove=T_REMOVE)
    assert masked_max3.launches == before + 1
    x = _lane_k1(2, 64, dev)
    m = masked_max3(x["gossip"], x["proc"], x["known"], x["hb"], x["ts"], T,
                    t_remove=T_REMOVE)
    assert m[0].shape == (2, 64, 64)


def test_grader_fleet_cuda_equals_cpu(dev, tmp_path):
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    from gossip_protocol_tpu_torch.grader import SCENARIOS, grade_all_fleet
    from gossip_protocol_tpu_torch.ops.drop import drop_masks_lanes
    from gossip_protocol_tpu_torch.ops.merge import masked_max3
    cfgs = [SimConfig.from_conf(f"testcases/{s}.conf") for s in SCENARIOS]
    before = (drop_masks_lanes.launches, masked_max3.launches)
    a = FleetSimulation(cfgs[0], device="cuda").run(configs=cfgs)
    assert (drop_masks_lanes.launches - before[0],
            masked_max3.launches - before[1]) == (700, 700)
    b = FleetSimulation(cfgs[0], device="cpu").run(configs=cfgs)
    for la, lb in zip(a.lanes, b.lanes):
        for name in ("added", "removed", "sent", "recv"):
            assert np.array_equal(getattr(la, name), getattr(lb, name))
    assert grade_all_fleet("testcases", str(tmp_path), "cuda")["total"] == 90


def test_grid_fleet_whole_run_equals_solo_lanes(dev):
    """A B=2 K5 fleet over a whole 608-tick N=4096 churn run equals each
    lane's solo K5 run."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    from gossip_protocol_tpu_torch.models import overlay_grid as og
    from gossip_protocol_tpu_torch.models.overlay import (
        init_overlay_state, make_overlay_schedule)
    cfg = SimConfig(max_nnb=4096, model="overlay", single_failure=False,
                    seed=0, total_ticks=608, churn_rate=0.2, rejoin_after=40,
                    step_rate=64.0 / 4096)
    res = FleetSimulation(cfg, device="cuda").run(seeds=[3, 4])
    for lane, s in zip(res.lanes, (3, 4)):
        c = cfg.replace(seed=s)
        fin, met = og.make_grid_run(cfg, 608, start_tick=0)(
            init_overlay_state(c, dev), make_overlay_schedule(c))
        for f in ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
                  "joinreq", "joinrep"):
            assert torch.equal(getattr(lane.final_state, f),
                               getattr(fin, f)), f
        for f in ("sent", "recv", "removals", "adds", "view_slots"):
            assert np.array_equal(getattr(lane.metrics, f),
                                  getattr(met, f).cpu().numpy()), f


@pytest.mark.parametrize("model", ["dense", "overlay"])
def test_pending_fleet_never_syncs_before_resolve(dev, model):
    """launch(defer=True), start and is_ready under the sync-debug mode
    "error": nothing synchronizes the device before resolve."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    if model == "dense":
        cfg = SimConfig(max_nnb=64, single_failure=False, drop_msg=True,
                        msg_drop_prob=0.1, seed=0, total_ticks=120,
                        rejoin_after=20)
    else:
        cfg = SimConfig(max_nnb=4096, model="overlay", single_failure=False,
                        seed=0, total_ticks=272, churn_rate=0.2,
                        rejoin_after=40, step_rate=64.0 / 4096)
    sim = FleetSimulation(cfg, device="cuda")
    ref = sim.run(seeds=[1, 2], warmup=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = sim.launch(seeds=[1, 2], warmup=False, defer=True)
        assert not pending.started
        pending.start()
        polls = 0
        while not pending.is_ready():
            polls += 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res = pending.resolve()
    for la, lb in zip(ref.lanes, res.lanes):
        if model == "dense":
            assert np.array_equal(la.added, lb.added)
            assert np.array_equal(la.sent, lb.sent)
        else:
            assert np.array_equal(la.metrics.sent, lb.metrics.sent)
            assert torch.equal(la.final_state.ids, lb.final_state.ids)


# ------------------------------------------ the corner draw and serving

@pytest.mark.parametrize("worlds", ("thresholds", "groups", "both"))
@pytest.mark.parametrize("n,na", ((16, 13), (1024, 1000), (1024, 900)))
def test_drop_masks_corner_worlds(dev, n, na, worlds):
    """A canonical rung's draw: thresholds read at the ``na x na`` corner
    of the N x N plane, the partition gated over all N, in the solo
    kernel (8 ticks, window and partition open and closed) and the lane
    kernel (3 lanes), each equal to its plain version."""
    from gossip_protocol_tpu_torch.ops.drop import (LaneDrop, drop_masks,
                                                    drop_masks_lanes,
                                                    drop_masks_lanes_plain,
                                                    drop_masks_plain)
    from gossip_protocol_tpu_torch.utils.threefry import prng_key
    rng = np.random.default_rng(n + na)
    b = 3
    lp = torch.from_numpy((rng.random((b, n, n)) * 0.3).astype(np.float32)) \
        .to(dev) if worlds != "groups" else None
    grp = torch.from_numpy(rng.integers(0, 3, (b, n)).astype(np.int32)) \
        .to(dev) if worlds != "thresholds" else None
    active = [True, False, True, False, True, True, False, False]
    part = [True, True, False, False, True, False, True, False]
    kw = dict(link_prob=None if lp is None else lp[0],
              group=None if grp is None else grp[0],
              part_active=part if grp is not None else None)
    before = drop_masks.launches
    got = drop_masks(prng_key(n), 100, active, np.float32(0.1), n, na,
                     dev, **kw)
    assert drop_masks.launches == before + 1
    want = drop_masks_plain(prng_key(n), 100, active, np.float32(0.1), n,
                            na, dev, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert got[0].any()
    if grp is None:
        assert not got[0][:, na:].any() and not got[0][:, :, na:].any()
    act = np.ones((b, 400), bool)
    act[1, :200] = False
    prt = np.zeros((b, 400), bool)
    prt[0] = True
    plan = LaneDrop(np.stack([prng_key(s) for s in range(b)]),
                    np.float32([0.1, 0.2, 0.3]), act,
                    prt if grp is not None else None)
    for t in (100, 300):
        before = drop_masks_lanes.launches
        got = drop_masks_lanes(plan, t, n, na, dev, lp, grp)
        assert drop_masks_lanes.launches == before + 1
        want = drop_masks_lanes_plain(plan, t, n, na, dev, lp, grp)
        torch.cuda.synchronize()
        assert all(torch.equal(a, w) for a, w in zip(got, want))


def _digests(handles):
    import importlib
    pr = importlib.import_module("gossip_protocol_tpu_torch.service.replay")
    return [pr.result_digest(h.result()) for h in handles]


def test_fleet_service_cuda_equals_cpu(dev):
    """A small mixed stream through FleetService on cuda and on cpu:
    exact and canonical buckets (asym at n=13 in rung 16, partition +
    drop at n=12), every request's digest equal, no failure counted."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.service import (FleetService,
                                                   grader_templates,
                                                   overlay_templates)
    base = dict(single_failure=True, total_ticks=80, fail_tick=30)
    canon = [SimConfig(**base, max_nnb=13, drop_msg=True, msg_drop_prob=0.1,
                       asym_drop=True, drop_open_tick=10, drop_close_tick=60,
                       seed=s) for s in (1, 2, 3)] \
        + [SimConfig(**base, max_nnb=12, drop_msg=True, msg_drop_prob=0.1,
                     partition_groups=2, partition_open_tick=20,
                     partition_close_tick=50, drop_open_tick=5 + s,
                     drop_close_tick=60, seed=s) for s in (1, 2)]
    tpls = grader_templates() + overlay_templates(n=128, ticks=48)
    out = {}
    for d in ("cuda", "cpu"):
        svc = FleetService(max_batch=4, canonicalize=True, device=d)
        hs = [svc.submit(t.cfg, seed=s, mode=t.mode)
              for s in (1000, 1001) for t in tpls]
        hs += [svc.submit(c) for c in canon]
        svc.drain()
        st = svc.stats()
        assert st["failures"]["retries"] == 0, st["last_errors"]
        assert st["failures"]["degraded_requests"] == 0
        out[d] = _digests(hs)
    assert out["cuda"] == out["cpu"]


def test_service_pump_never_syncs(dev):
    """The pipelined pump under the sync-debug mode "error": submits
    that stage and launch full buckets, and idle pumps that poll the
    ring heads' CUDA events, never synchronize the device.  Resolution
    (the fetch, which must wait) is held until the mode is off, then the
    results equal a synchronous service's."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.service import FleetService
    cfg = SimConfig(max_nnb=64, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=0, total_ticks=120,
                    rejoin_after=20)
    ov = SimConfig(max_nnb=4096, model="overlay", single_failure=False,
                   drop_msg=False, seed=0, total_ticks=272, churn_rate=0.2,
                   rejoin_after=40, step_rate=64.0 / 4096)
    svc = FleetService(max_batch=2, device="cuda", pipeline_depth=2)
    svc.warm(cfg)
    svc.warm(ov)
    ref = FleetService(max_batch=2, device="cuda", pipeline=False)
    hr = [ref.submit(c, seed=s) for c in (cfg, ov) for s in (1, 2, 3, 4)]
    ref.drain()
    resolve, held = svc._resolve, []
    svc._resolve = held.append         # the harvest's fetch, deferred
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hs = [svc.submit(c, seed=s) for c in (cfg, ov) for s in (1, 2, 3, 4)]
        polls = 0
        while svc.in_flight and polls < 100000:
            svc.pump()
            polls += 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
        svc._resolve = resolve
    # the four batches (two a bucket, one ring slot each) were all found
    # ready by polls, during the submits or the idle pumps
    assert svc.stats()["ring_stalls"] == 0 and svc.in_flight == 0
    assert len(held) == 4
    for infl in held:
        resolve(infl)
    svc.drain()
    assert _digests(hs) == _digests(hr)
    assert svc.stats()["failures"]["retries"] == 0


# ---- multi-device execution on a mesh of one card -----------------------

def _rect(r, s, c, seed, dev, lanes=None):
    g = torch.Generator().manual_seed(seed)
    lead = () if lanes is None else (lanes,)

    def b(p, shape):
        return (torch.rand(lead + shape, generator=g) < p).to(dev)

    def i(lo, hi, shape):
        return torch.randint(lo, hi, lead + shape, generator=g,
                             dtype=torch.int32).to(dev)

    return (b(0.25, (s, r)), b(0.9, (r,)), b(0.7, (s, c)),
            i(0, 600, (s, c)), i(T - 40, T + 1, (s, c)))


@pytest.mark.parametrize("r,s,c", [(5, 5, 10), (7, 12, 30), (33, 2, 40),
                                   (128, 128, 1024), (300, 257, 700),
                                   (512, 512, 4096), (1024, 1024, 4096)])
@pytest.mark.parametrize("lanes", [None, 2])
def test_rect_masked_max3_equals_plain(dev, r, s, c, lanes):
    """The merge's rectangular form (an S x R delivery block against
    S x C payload rows), solo and with a lane axis, == its plain version;
    it counts on ``rect_launches`` unless square."""
    from gossip_protocol_tpu_torch.ops.merge import (masked_max3,
                                                     masked_max3_lanes_plain,
                                                     masked_max3_plain)
    x = _rect(r, s, c, r * 7 + c, dev, lanes)
    before = (masked_max3.launches, masked_max3.rect_launches)
    got = masked_max3(*x, T, t_remove=T_REMOVE)
    assert masked_max3.launches == before[0] + 1
    assert masked_max3.rect_launches == before[1] + int(not r == s == c)
    plain = masked_max3_lanes_plain if lanes else masked_max3_plain
    want = plain(*x, T, t_remove=T_REMOVE)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def _shard_k3(args, kw, p, s):
    idsaux, pw, intro, masks, scalars = args
    nl = idsaux.shape[0] // p

    def rows(t, q):
        return t[q * nl:(q + 1) * nl]

    return ((rows(idsaux, s), rows(pw, s), intro, masks, scalars),
            dict(kw, masks_local=[m % nl for m in masks], row_start=s * nl,
                 aux_rounds=[rows(idsaux, s ^ (m // nl)) for m in masks],
                 pw_rounds=[rows(pw, s ^ (m // nl)) for m in masks]), nl)


@pytest.mark.parametrize("name,n,p", [("powerlaw", 1 << 16, 4),
                                      ("churn", 1 << 16, 8),
                                      ("churn", 64, 8)])
def test_fused_overlay_tick_sharded_equals_plain(dev, name, n, p):
    """K3's sharded contract on every shard of a random state's tick ==
    its plain version == the single-device kernel's rows."""
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
        fused_overlay_tick, fused_overlay_tick_plain)
    cfg = _grid_cfg(name, n)
    got = {}

    def keep(*args, **kw):
        got.update(args=args, kw=kw)
        return fused_overlay_tick_plain(*args, **kw)

    pov.make_overlay_tick(cfg, exchange=keep)(
        _random_state(cfg, 140, 9, dev), pov.make_overlay_schedule(cfg))
    whole = fused_overlay_tick(*got["args"], **got["kw"])
    for s in range(p):
        args, kw, nl = _shard_k3(got["args"], got["kw"], p, s)
        before = fused_overlay_tick.sharded_launches
        a = fused_overlay_tick(*args, **kw)
        assert fused_overlay_tick.sharded_launches == before + 1
        b = fused_overlay_tick_plain(*args, **kw)
        torch.cuda.synchronize()
        for x, y, w in zip(a, b, whole):
            assert torch.equal(x, y)
            assert torch.equal(x, w[s * nl:(s + 1) * nl])


def test_sharded_runs_cuda_equal_cpu(dev):
    """A peer-sharded dense run on cuda:0 x 4 and an overlay run on
    cuda:0 x 2 equal the same runs on cpu x P: the kernels under the
    mesh, every table, event and metric."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models.overlay_sharded import (
        make_overlay_mesh, make_sharded_overlay_run, shard_overlay_state)
    from gossip_protocol_tpu_torch.ops.merge import masked_max3
    from gossip_protocol_tpu_torch.parallel.sharded import (
        make_mesh, make_sharded_run, shard_state)
    from gossip_protocol_tpu_torch.state import init_state, make_schedule
    cfg = SimConfig(max_nnb=64, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=3, total_ticks=120)
    outs = []
    for d in (dev, "cpu"):
        mesh = make_mesh(4, device=d)
        r0 = masked_max3.rect_launches
        outs.append(make_sharded_run(cfg, mesh)(
            shard_state(init_state(cfg, d), mesh), make_schedule(cfg, d)))
        if d == dev:
            assert masked_max3.rect_launches - r0 == 120 * 16
    torch.cuda.synchronize()
    (fa, ea), (fb, eb) = outs
    for f in ("known", "hb", "ts", "gossip", "in_group", "own_hb"):
        assert torch.equal(getattr(fa, f).cpu(), getattr(fb, f))
    for f in ("added", "removed", "sent", "recv"):
        assert torch.equal(getattr(ea, f).cpu(), getattr(eb, f))
    ocfg = SimConfig(model="overlay", max_nnb=64, seed=3, total_ticks=90,
                     single_failure=False, churn_rate=0.3, rejoin_after=20,
                     step_rate=0.25)
    res = []
    for d in (dev, "cpu"):
        mesh = make_overlay_mesh(2, device=d)
        res.append(make_sharded_overlay_run(ocfg, mesh)(
            shard_overlay_state(pov.init_overlay_state(ocfg, d), mesh),
            pov.make_overlay_schedule(ocfg)))
    (fa, ma), (fb, mb) = res
    for f in ("ids", "hb", "ts", "send_flags", "in_group", "own_hb"):
        assert torch.equal(getattr(fa, f).cpu(), getattr(fb, f))
    for f in ("in_group", "view_slots", "adds", "removals", "sent", "recv"):
        assert torch.equal(getattr(ma, f).cpu(), getattr(mb, f))


def test_mesh_fleet_never_syncs_before_resolve(dev):
    """A lane-mesh and a 2-D mesh fleet launch: deferred, started and
    polled under set_sync_debug_mode("error"); the lanes then equal the
    single-device fleet's."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    from gossip_protocol_tpu_torch.parallel.fleet_mesh import (
        MeshFleetSimulation, make_lane_mesh, make_lane_peer_mesh)
    cfg = SimConfig(max_nnb=64, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=0, total_ticks=80)
    ref = FleetSimulation(cfg).run_bench(seeds=range(4))
    for mesh in (make_lane_mesh(2), make_lane_peer_mesh(2, 2)):
        sim = MeshFleetSimulation(cfg, mesh)
        sim.run_bench(seeds=range(4))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pend = sim.launch_bench(seeds=range(4), warmup=False,
                                    defer=True)
            pend.start()
            while not pend.is_ready():
                pass
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = pend.resolve()
        for a, b in zip(got.lanes, ref.lanes):
            assert np.array_equal(a.sent, b.sent)
            assert torch.equal(a.final_state.hb, b.final_state.hb)


@pytest.mark.parametrize("world", [
    dict(link_latency=4, zombie=True),
    dict(partition_groups=2, partition_open_tick=30, partition_close_tick=60,
         drop_msg=True, msg_drop_prob=0.1, asym_drop=True, drop_open_tick=10,
         drop_close_tick=80)])
def test_sharded_world_runs_cuda_equal_cpu(dev, world):
    """A world config's peer-sharded overlay run on cuda:0 x 2 equals the
    same run on cpu x 2 and the single-device cuda run: every table,
    vector and metric; no K3 launch."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.models.overlay_sharded import (
        make_overlay_mesh, make_sharded_overlay_run, shard_overlay_state)
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import \
        fused_overlay_tick
    cfg = SimConfig(**{**dict(model="overlay", max_nnb=64, seed=3,
                              total_ticks=90, single_failure=True,
                              drop_msg=False, fail_tick=30), **world})
    sched = pov.make_overlay_schedule(cfg)
    k3 = fused_overlay_tick.launches
    res = []
    for d in (dev, "cpu"):
        mesh = make_overlay_mesh(2, device=d)
        res.append(make_sharded_overlay_run(cfg, mesh)(
            shard_overlay_state(pov.init_overlay_state(cfg, d), mesh), sched))
    res.append(pov.make_overlay_run(cfg)(pov.init_overlay_state(cfg, dev),
                                         sched))
    torch.cuda.synchronize()
    assert fused_overlay_tick.launches == k3
    (fa, ma), (fb, mb), (fc, mc) = res
    for f in ("ids", "hb", "ts", "send_flags", "send_hist", "in_group",
              "own_hb", "joinreq", "joinrep"):
        assert torch.equal(getattr(fa, f).cpu(), getattr(fb, f)), f
        assert torch.equal(getattr(fa, f), getattr(fc, f)), f
    for f in pov.METRIC_FIELDS:
        assert torch.equal(getattr(ma, f).cpu(), getattr(mb, f)), f
        assert torch.equal(getattr(ma, f), getattr(mc, f)), f


# ------------------------------------------------ the analysis on the card

def test_analysis_runtime_and_guards_clean_on_cuda(dev):
    """The runtime and guard passes on the card: the solo tick loops and
    a launched fleet's wait and resolve run under the sync-debug mode
    "error" without raising, a warmed lap builds nothing, no nvcc."""
    from gossip_protocol_tpu_torch.analysis import guards, runtime
    findings = runtime.check(device="cuda") + guards.self_check(
        device="cuda")
    assert findings == [], "\n".join(str(f) for f in findings)


def test_sync_in_tick_loop_is_caught_on_cuda(dev):
    """no-transfer-in-scan fires on a tick loop that reads a device value
    to the host."""
    from gossip_protocol_tpu_torch.analysis import runtime

    def run(device, section):
        x = torch.ones(4, device=device)
        with section(sync=True):
            float(x.sum())
        return runtime.Observation(ticks=1, expected_draws={})
    prog = runtime.Program("fixture-sync", "test", ("no-transfer-in-scan",),
                           run)
    findings = runtime.check_observation(prog,
                                         runtime.observe(prog, "cuda"))
    assert [f.rule for f in findings] == ["no-transfer-in-scan"]
