"""The adversarial worlds (worlds.py) in the port, against the live JAX package.

Every world draw, the drop draw with per-link thresholds and partition
groups, the dense tick and the overlay run of each world, the routing
the worlds force and checkpoints carrying the latency world's in-flight
state: each equal to the JAX package on the same config and seed, bit
for bit.  The port runs its kernels' plain versions (the CPU); JAX runs
its XLA paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_protocol_tpu import worlds as jw
from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.core.sim import Simulation as JaxSimulation
from gossip_protocol_tpu.core.tick import make_tick as jax_make_tick
from gossip_protocol_tpu.models import overlay as jov
from gossip_protocol_tpu.ops.drop import tick_drop_masks as jax_drop
from gossip_protocol_tpu.state import init_state as jax_init_state
from gossip_protocol_tpu.state import make_schedule as jax_make_schedule
from gossip_protocol_tpu.state import save_checkpoint as jax_save
from gossip_protocol_tpu.state import load_checkpoint as jax_load
from gossip_protocol_tpu_torch import worlds
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.sim import Simulation
from gossip_protocol_tpu_torch.core.tick import make_tick
from gossip_protocol_tpu_torch.models import overlay as pov
from gossip_protocol_tpu_torch.models.scenarios import CATALOG
from gossip_protocol_tpu_torch.ops.drop import drop_masks_plain
from gossip_protocol_tpu_torch.state import (init_state, load_checkpoint,
                                             make_schedule, save_checkpoint)
from gossip_protocol_tpu_torch.utils.threefry import prng_key
from test_torch_tick import assert_events_equal, assert_state_equal

torch.set_num_threads(2)

DENSE_WORLDS = {
    "partition": dict(partition_groups=2, partition_open_tick=30,
                      partition_close_tick=70),
    "asym_drop": dict(drop_msg=True, msg_drop_prob=0.12, asym_drop=True,
                      drop_open_tick=10, drop_close_tick=90),
    "wave": dict(single_failure=False, wave_size=6, wave_tick=40,
                 wave_speed=2),
    "zombie": dict(zombie=True),
    "flapping": dict(flap_rate=0.4, flap_period=24, flap_down=6,
                     fail_tick=10_000),
    "byz": dict(max_nnb=32, byz_rate=0.2, byz_boost=8),
    "latency": dict(link_latency=4),
    "byz_latency": dict(max_nnb=32, byz_rate=0.2, byz_boost=8,
                        link_latency=4),
    "zombie_latency": dict(zombie=True, link_latency=3),
}

OVERLAY_WORLDS = {
    "partition": dict(partition_groups=2, partition_open_tick=30,
                      partition_close_tick=60),
    "asym_drop": dict(drop_msg=True, msg_drop_prob=0.1, asym_drop=True,
                      drop_open_tick=10, drop_close_tick=80),
    "wave": dict(single_failure=False, wave_size=6, wave_tick=40,
                 wave_speed=2),
    "zombie": dict(zombie=True),
    "flapping": dict(flap_rate=0.3, flap_period=24, flap_down=6,
                     fail_tick=10_000),
    "byz": dict(byz_rate=0.15, byz_boost=8),
    "latency": dict(link_latency=4),
    "byz_latency": dict(byz_rate=0.15, byz_boost=4, link_latency=3),
    "zombie_latency": dict(zombie=True, link_latency=3),
    "zombie_asym": dict(zombie=True, drop_msg=True, msg_drop_prob=0.06,
                        asym_drop=True, drop_open_tick=10,
                        drop_close_tick=90),
}


def _dense(**kw):
    base = dict(max_nnb=16, single_failure=True, drop_msg=False, seed=2,
                total_ticks=120, fail_tick=40)
    base.update(kw)
    return base


def _overlay(**kw):
    base = dict(model="overlay", max_nnb=64, single_failure=True,
                drop_msg=False, seed=2, total_ticks=96, fail_tick=40,
                step_rate=8.0 / 64)
    base.update(kw)
    return base


def _catalog_kw(name, seed=1000):
    return CATALOG[name].build(seed).to_dict()


# ---------------------------------------------------------- host draws

@pytest.mark.parametrize("name", sorted(CATALOG))
def test_world_host_draws_equal_jax(name):
    """Every worlds.py host draw, window and key of a catalog config
    equals the JAX package's, array for array and dtype for dtype."""
    kw = _catalog_kw(name)
    cfg, jcfg = SimConfig(**kw), JaxConfig(**kw)
    for fn in ("wave_fail_ticks", "partition_groups_host", "link_prob_host",
               "flap_mask_host", "flap_anchor_host", "byz_mask_host",
               "byz_target_host", "link_latency_host"):
        a, b = getattr(worlds, fn)(cfg), getattr(jw, fn)(jcfg)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, fn)
        assert np.array_equal(a, b), (name, fn)
    for fn in ("wave_start", "wave_last_fail", "wave_center", "flap_window",
               "partition_window", "flap_threshold", "byz_threshold",
               "composition"):
        assert getattr(worlds, fn)(cfg) == getattr(jw, fn)(jcfg), (name, fn)
    assert worlds.canonical_world_key(cfg, 16) \
        == jw.canonical_world_key(jcfg, 16)
    assert worlds.OPERAND_WORLD_FIELDS == jw.OPERAND_WORLD_FIELDS
    assert worlds.PLANES == jw.PLANES
    if cfg.flap_rate > 0:
        a, b = worlds.make_flap_state(cfg), jw.make_flap_state(jcfg)
        for i in range(cfg.n):
            for t in range(cfg.total_ticks):
                assert a(i, t) == b(i, t), (name, i, t)


@pytest.mark.parametrize("n, lat", [(16, 4), (64, 23), (1 << 20, 7)])
def test_link_latency_of_equals_jax(n, lat):
    rng = np.random.default_rng(n)
    iu = rng.integers(0, n, 4096).astype(np.uint32)
    ju = rng.integers(0, n, 4096).astype(np.uint32)
    want = np.asarray(jw.link_latency_of(np.uint32(77), iu, ju, n, lat))
    got = worlds.link_latency_of(77, torch.from_numpy(iu.astype(np.int64)),
                                 torch.from_numpy(ju.astype(np.int64)), n,
                                 lat)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_link_prob_rounds_as_jax():
    """``link_prob_host`` scales in float64, then casts: a probability
    near a float32 rounding edge lands on the JAX package's value."""
    for p in (0.1, 0.12, 1 / 3, 0.499999):
        kw = _dense(max_nnb=48, drop_msg=True, msg_drop_prob=p,
                    asym_drop=True)
        a = worlds.link_prob_host(SimConfig(**kw))
        b = jw.link_prob_host(JaxConfig(**kw))
        assert a.dtype == np.float32 and np.array_equal(a, b), p


@pytest.mark.parametrize("name", sorted(n for n in CATALOG
                                        if n.startswith("overlay")))
def test_overlay_schedule_world_draws_equal_jax(name):
    """The overlay's traced world draws (fail/rejoin with the wave, flap,
    liars, groups, per-link thresholds, the zombie window) equal the JAX
    ``OverlaySchedule``'s over every id and a span of ticks."""
    kw = _catalog_kw(name)
    cfg = SimConfig(**kw)
    s = pov.make_overlay_schedule(cfg)
    js = jov.make_overlay_schedule(JaxConfig(**kw))
    n = cfg.n
    i = torch.arange(n, dtype=torch.int64)
    ji = jnp.arange(n, dtype=jnp.int32)

    def eq(a, b, what):
        assert np.array_equal(a.numpy().astype(np.int64),
                              np.asarray(b).astype(np.int64)), (name, what)

    eq(s.fail_of(i), js.fail_of(ji), "fail_of")
    eq(s.rejoin_of(i), js.rejoin_of(ji), "rejoin_of")
    eq(s.byz_of(i), js.byz_of(ji), "byz_of")
    eq(s.group_of(i), js.group_of(ji), "group_of")
    eq(s.link_thr(i[:, None], i[None, :]),
       js.link_thr(ji[:, None].astype(jnp.uint32),
                   ji[None, :].astype(jnp.uint32)), "link_thr")
    for t in range(0, cfg.total_ticks, 3):
        for k, (a, b) in enumerate(zip(s.flap(i, t), js._flap(ji, t))):
            eq(a, b, f"flap[{k}] t={t}")
        eq(s.failed_at(i, t), js.failed_at(ji, t), f"failed_at t={t}")
        eq(s.window_failed_at(i, t), js.window_failed_at(ji, t),
           f"window_failed_at t={t}")
        eq(s.rejoining_at(i, t), js.rejoining_at(ji, t), f"rejoin t={t}")
        assert s.part_active(t) == bool(js.part_active(t)), (name, t)


@pytest.mark.parametrize("name", sorted(n for n in CATALOG
                                        if n.startswith("dense")))
def test_dense_schedule_worlds_equal_jax(name):
    """The dense ``Schedule``'s world fields and its flap-aware
    ``failed_at`` / ``window_failed_at`` / ``rejoining_at`` /
    ``part_active_at`` equal the JAX ``Schedule``'s at every tick."""
    from gossip_protocol_tpu.state import make_schedule_host as jax_host
    from gossip_protocol_tpu_torch.state import SCHED_ARRAYS, \
        make_schedule_host
    kw = _catalog_kw(name)
    want = jax_host(JaxConfig(**kw))
    got = make_schedule_host(SimConfig(**kw))
    for f in SCHED_ARRAYS + ("drop_active",):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("part_on", "part_open", "part_close", "flap_period",
              "flap_down", "flap_close", "byz_boost", "drop_open",
              "drop_close"):
        assert getattr(got, f) == getattr(want, f).item(), f
    dev = make_schedule(SimConfig(**kw), "cpu")
    jdev = jax_make_schedule(JaxConfig(**kw))
    for t in range(SimConfig(**kw).total_ticks):
        for m in ("failed_at", "window_failed_at", "rejoining_at"):
            assert np.array_equal(getattr(dev, m)(t).numpy(),
                                  np.asarray(getattr(jdev, m)(t))), (m, t)
        assert dev.part_active_at(t) == bool(jdev.part_active_at(t)), t


# ------------------------------------------------------ the drop draw

@pytest.mark.parametrize("n", (10, 64))
@pytest.mark.parametrize("asym", (False, True))
@pytest.mark.parametrize("partition", (False, True))
def test_drop_masks_worlds_equal_jax(n, asym, partition):
    """The plain draw with per-link thresholds and groups equals JAX
    ``tick_drop_masks(link_prob=...)`` plus the tick's partition OR, on a
    launch covering drop window open / closed x partition open / closed
    (the gate sits outside the window)."""
    cfg = JaxConfig(**_dense(max_nnb=n, seed=n, drop_msg=True,
                             msg_drop_prob=0.2, asym_drop=True,
                             partition_groups=3, partition_open_tick=50,
                             partition_close_tick=90))
    link_prob = jw.link_prob_host(cfg) if asym else None
    group = jw.partition_groups_host(cfg) if partition else None
    active = [True, False, True, False, True]
    part = [True, True, False, False, True]
    rng = prng_key(cfg.seed)
    g, q, p = drop_masks_plain(rng, 60, active, np.float32(0.2), n,
                               link_prob=link_prob, group=group,
                               part_active=part if partition else None)
    key = jax.random.PRNGKey(cfg.seed)
    for s in range(len(active)):
        jg, jq, jp = (np.asarray(x) for x in jax_drop(
            key, 60 + s, n, active[s], np.float32(0.2),
            link_prob=None if link_prob is None else jnp.asarray(link_prob)))
        if partition and part[s]:
            cross = group[:, None] != group[None, :]
            jg, jq, jp = jg | cross, jq | cross[:, 0], jp | cross[0, :]
        assert np.array_equal(g[s].numpy(), jg), s
        assert np.array_equal(q[s].numpy(), jq), s
        assert np.array_equal(p[s].numpy(), jp), s
    if partition:
        # a closed drop window with the partition open: the gate alone
        assert g[1].any() and not (g[1] ^ torch.from_numpy(
            group[:, None] != group[None, :])).any()


# ---------------------------------------------------- the dense model

@pytest.mark.parametrize("name", sorted(DENSE_WORLDS))
def test_dense_world_ticks_equal_jax(name):
    """Each dense world, tick by tick: the whole state (gossip_age
    included) and the tick's events equal the JAX XLA tick's."""
    kw = _dense(**DENSE_WORLDS[name])
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jtick = jax.jit(jax_make_tick(jcfg, use_pallas=False))
    jsched, jstate = jax_make_schedule(jcfg), jax_init_state(jcfg)
    tick = make_tick(cfg)
    sched, state = make_schedule(cfg, "cpu"), init_state(cfg, "cpu")
    removed = 0
    for t in range(cfg.total_ticks):
        jstate, jev = jtick(jstate, jsched)
        state, ev = tick(state, sched)
        assert_state_equal(state, jstate, (name, t))
        assert_events_equal(ev, jev, (name, t))
        removed += int(ev.removed.sum())
    if cfg.link_latency:
        assert int(state.gossip_age.max()) > 0, "no message waited"
    assert removed or name == "flapping", "the world never bit"


@pytest.mark.parametrize("name", sorted(DENSE_WORLDS))
def test_dense_world_logs_equal_jax(name, tmp_path):
    """Each dense world through ``Simulation.run`` (the wave through K2's
    plain version): event masks, counters and the three log files' bytes
    equal the JAX package's."""
    kw = _dense(**DENSE_WORLDS[name])
    j = JaxSimulation(JaxConfig(**kw)).run()
    p = Simulation(SimConfig(**kw), device="cpu").run()
    for f in ("added", "removed", "sent", "recv", "fail_tick",
              "rejoin_tick"):
        assert np.array_equal(np.asarray(getattr(j, f)), getattr(p, f)), f
    for tag, r in (("jax", j), ("port", p)):
        (tmp_path / tag).mkdir()
        r.write_logs(str(tmp_path / tag))
    for f in ("dbg.log", "msgcount.log", "stats.log"):
        assert (tmp_path / "jax" / f).read_bytes() \
            == (tmp_path / "port" / f).read_bytes(), f


def test_dense_world_routes():
    """Worlds take no corner; of them only the wave rides K2."""
    from gossip_protocol_tpu_torch.core.dense_corner import active_bound
    from gossip_protocol_tpu_torch.core.dense_mega import \
        dense_mega_supported
    from gossip_protocol_tpu.core.dense_corner import \
        active_bound as jax_active_bound
    from gossip_protocol_tpu.core.dense_mega import \
        dense_mega_supported as jax_mega
    for name, w in DENSE_WORLDS.items():
        kw = _dense(**dict(w, max_nnb=512, total_ticks=100))
        cfg, jcfg = SimConfig(**kw), JaxConfig(**kw)
        assert active_bound(cfg) == jax_active_bound(jcfg) == cfg.n, name
        for ev in (True, False):
            assert dense_mega_supported(cfg, ev) == jax_mega(jcfg, ev) \
                == (name == "wave"), name
    # a narrower drop stream (a canonical rung's lanes) now draws the
    # asym thresholds at its corner, tick for tick as the JAX tick does
    kw = _dense(**DENSE_WORLDS["asym_drop"])
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    na = cfg.n - 4
    jtick = jax.jit(jax_make_tick(jcfg, use_pallas=False, n_active=na))
    jsched, jstate = jax_make_schedule(jcfg), jax_init_state(jcfg)
    tick = make_tick(cfg, n_active=na)
    sched, state = make_schedule(cfg, "cpu"), init_state(cfg, "cpu")
    for t in range(70):
        jstate, jev = jtick(jstate, jsched)
        state, ev = tick(state, sched)
        assert_state_equal(state, jstate, ("asym n_active", t))
        assert_events_equal(ev, jev, ("asym n_active", t))


# -------------------------------------------------- the overlay model

OV_STATE = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
            "send_hist", "joinreq", "joinrep")


def _assert_overlay_equal(p, j, where):
    for f in OV_STATE:
        a = getattr(p.final_state, f).numpy()
        b = np.asarray(getattr(j.final_state, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f)
    assert p.final_state.tick == int(np.asarray(j.final_state.tick))
    for f in pov.METRIC_FIELDS:
        assert np.array_equal(np.asarray(getattr(p.metrics, f)),
                              np.asarray(getattr(j.metrics, f))), (where, f)


@pytest.mark.parametrize("name", sorted(OVERLAY_WORLDS))
def test_overlay_world_run_equals_jax(name, monkeypatch):
    """Each overlay world: the final state (send_hist included), every
    per-tick metric (live_uncovered included) and the final coverage
    equal the JAX XLA tick's; K3's plain version is never reached."""
    from gossip_protocol_tpu_torch.ops.cuda import overlay_exchange

    def no_k3(*a, **k):
        raise AssertionError("a world config reached K3")
    monkeypatch.setattr(overlay_exchange, "fused_overlay_tick_plain", no_k3)
    kw = _overlay(**OVERLAY_WORLDS[name])
    j = jov.OverlaySimulation(JaxConfig(**kw), use_pallas=False).run()
    p = pov.OverlaySimulation(SimConfig(**kw), device="cpu").run()
    _assert_overlay_equal(p, j, name)
    assert p.final_coverage() == j.final_coverage()
    assert np.array_equal(p.uncovered_members(), j.uncovered_members())
    if kw.get("link_latency"):
        assert int(p.final_state.send_hist.max()) > 1


def test_overlay_world_routes():
    """World configs never take K3, K4 or K5: the envelopes exclude
    them, and asking for a kernel route raises."""
    from gossip_protocol_tpu_torch.models.overlay_grid import grid_supported
    from gossip_protocol_tpu_torch.models.overlay_mega import mega_supported
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import \
        fused_overlay_tick_plain
    for w in OVERLAY_WORLDS.values():
        cfg = SimConfig(**_overlay(**w))
        assert not mega_supported(cfg) and not grid_supported(cfg)
        for kw in (dict(mega=True), dict(grid=True)):
            with pytest.raises(ValueError):
                pov.make_overlay_run(cfg, **kw)
        with pytest.raises(ValueError):
            pov.make_overlay_tick(cfg, exchange=fused_overlay_tick_plain)


# -------------------------------------------------------- checkpoints

def test_dense_checkpoint_with_gossip_age_both_ways(tmp_path):
    """A latency world's dense checkpoint, cut with messages in flight
    (nonzero ``gossip_age``), resumes bit-identically in either package."""
    kw = _dense(max_nnb=24, zombie=True, link_latency=4)
    cfg, jcfg = SimConfig(**kw), JaxConfig(**kw)
    whole = Simulation(cfg, device="cpu").run()
    jmid = JaxSimulation(jcfg).run(ticks=61).final_state
    assert np.asarray(jmid.gossip_age).any()
    jax_save(jmid, str(tmp_path / "jax.npz"))
    res = Simulation(cfg, device="cpu").run(
        resume_from=load_checkpoint(str(tmp_path / "jax.npz"), "cpu"))
    assert np.array_equal(res.removed, whole.removed[61:])
    assert_state_equal(res.final_state, JaxSimulation(jcfg).run().final_state)
    pmid = Simulation(cfg, device="cpu").run(ticks=61).final_state
    save_checkpoint(pmid, str(tmp_path / "port.npz"))
    jres = JaxSimulation(jcfg).run(
        resume_from=jax_load(str(tmp_path / "port.npz")))
    assert_state_equal(whole.final_state, jres.final_state)


def test_overlay_checkpoint_with_send_hist_both_ways(tmp_path):
    """An overlay latency world's checkpoint with a nonzero send history
    resumes bit-identically in either package."""
    kw = _overlay(link_latency=4, zombie=True)
    cfg, jcfg = SimConfig(**kw), JaxConfig(**kw)
    whole = pov.OverlaySimulation(cfg, device="cpu").run()
    jwhole = jov.OverlaySimulation(jcfg, use_pallas=False).run()
    jmid = jov.OverlaySimulation(jcfg, use_pallas=False).run(ticks=50)
    assert np.asarray(jmid.final_state.send_hist).max() > 1
    jov.save_overlay_checkpoint(jmid.final_state, str(tmp_path / "j.npz"))
    back = pov.load_overlay_checkpoint(str(tmp_path / "j.npz"), "cpu")
    res = pov.OverlaySimulation(cfg, device="cpu").run(resume_from=back)
    for f in OV_STATE:
        assert torch.equal(getattr(res.final_state, f),
                           getattr(whole.final_state, f)), f
    pmid = pov.OverlaySimulation(cfg, device="cpu").run(ticks=50)
    pov.save_overlay_checkpoint(pmid.final_state, str(tmp_path / "p.npz"))
    jres = jov.OverlaySimulation(jcfg, use_pallas=False).run(
        resume_from=jov.load_overlay_checkpoint(str(tmp_path / "p.npz")))
    for f in OV_STATE:
        assert np.array_equal(np.asarray(getattr(jres.final_state, f)),
                              np.asarray(getattr(jwhole.final_state, f))), f
