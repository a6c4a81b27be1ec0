"""Seeded fuzz of the port against the live JAX package (``slow``).

Small dense and overlay configs are drawn from fixed seeds, every world
knob included (partition, asym drop, wave, zombie, flap, byz, latency,
churn and drops around them).  A config both packages accept must run to
the same arrays: dense state, events and counters; overlay state and
every metric.  A config the JAX package refuses, at build or at run
time, must raise the same error in the port.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.core.sim import Simulation as JaxSimulation
from gossip_protocol_tpu.models.overlay import \
    OverlaySimulation as JaxOverlaySimulation
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.sim import Simulation
from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation

torch.set_num_threads(2)

pytestmark = pytest.mark.slow


def _worlds(rng, total: int) -> dict:
    """A random subset of the world knobs, windows inside the run (some
    draws invalid on purpose: both packages must refuse them alike)."""
    kw = {}
    if rng.random() < 0.4:
        lo = int(rng.integers(0, total))
        kw.update(partition_groups=int(rng.integers(2, 4)),
                  partition_open_tick=lo,
                  partition_close_tick=lo + int(rng.integers(-2, 40)))
    if rng.random() < 0.4:
        lo = int(rng.integers(0, total // 2))
        kw.update(drop_msg=True, msg_drop_prob=float(rng.random() * 0.3),
                  drop_open_tick=lo,
                  drop_close_tick=lo + int(rng.integers(1, total)),
                  asym_drop=bool(rng.random() < 0.6))
    script = rng.integers(0, 3)
    if script == 1:
        kw.update(single_failure=False, wave_size=int(rng.integers(1, 8)),
                  wave_tick=int(rng.integers(-1, total // 2)),
                  wave_speed=int(rng.integers(1, 4)))
    elif script == 2 and rng.random() < 0.5:
        kw.update(rejoin_after=int(rng.integers(0, 40)))
    if rng.random() < 0.3:
        kw.update(zombie=True)
    if rng.random() < 0.3:
        lo = int(rng.integers(0, total // 3))
        kw.update(flap_rate=float(rng.random() * 0.5),
                  flap_period=int(rng.integers(4, 30)),
                  flap_down=int(rng.integers(1, 8)),
                  flap_open_tick=lo,
                  flap_close_tick=lo + int(rng.integers(0, total)))
    if rng.random() < 0.3:
        kw.update(byz_rate=float(rng.random() * 0.3),
                  byz_boost=int(rng.integers(0, 10)))
    if rng.random() < 0.3:
        kw.update(link_latency=int(rng.integers(1, 8)))
    return kw


def _dense_cfg(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    total = int(rng.integers(50, 130))
    kw = dict(max_nnb=int(rng.choice([8, 12, 16, 24])), seed=seed,
              total_ticks=total, fail_tick=int(rng.integers(10, total)),
              single_failure=bool(rng.random() < 0.5),
              t_remove=int(rng.choice([6, 10, 20])))
    kw.update(_worlds(rng, total))
    return kw


def _overlay_cfg(seed: int) -> dict:
    rng = np.random.default_rng(10_000 + seed)
    total = int(rng.integers(60, 140))
    n = int(rng.choice([16, 32, 64]))
    kw = dict(model="overlay", max_nnb=n, seed=seed, total_ticks=total,
              fail_tick=int(rng.integers(10, total)),
              single_failure=bool(rng.random() < 0.5), step_rate=8.0 / n,
              t_remove=int(rng.choice([8, 12, 20])))
    kw.update(_worlds(rng, total))
    if "wave_size" not in kw and rng.random() < 0.2:
        kw.update(churn_rate=0.2, rejoin_after=int(rng.integers(5, 30)))
    return kw


def _refusal(fn):
    """The exception ``fn`` raises, or None."""
    try:
        return None, fn()
    except (ValueError, NotImplementedError) as e:
        return e, None


def _same_refusal(jax_err, port_fn):
    with pytest.raises(type(jax_err)) as got:
        port_fn()
    assert str(got.value) == str(jax_err)


@pytest.mark.parametrize("seed", range(16))
def test_dense_fuzz_equals_jax(seed):
    kw = _dense_cfg(seed)
    err, jcfg = _refusal(lambda: JaxConfig(**kw))
    if err is not None:
        return _same_refusal(err, lambda: SimConfig(**kw))
    cfg = SimConfig(**kw)
    err, j = _refusal(lambda: JaxSimulation(jcfg).run())
    if err is not None:
        return _same_refusal(err, lambda: Simulation(cfg, device="cpu").run())
    p = Simulation(cfg, device="cpu").run()
    for f in ("added", "removed", "sent", "recv", "fail_tick",
              "rejoin_tick"):
        assert np.array_equal(np.asarray(getattr(j, f)), getattr(p, f)), f
    for f in ("in_group", "own_hb", "known", "hb", "ts", "gossip",
              "gossip_age", "joinreq", "joinrep"):
        assert np.array_equal(np.asarray(getattr(j.final_state, f)),
                              getattr(p.final_state, f).numpy()), f


@pytest.mark.parametrize("seed", range(16))
def test_overlay_fuzz_equals_jax(seed):
    kw = _overlay_cfg(seed)
    err, jcfg = _refusal(lambda: JaxConfig(**kw))
    if err is not None:
        return _same_refusal(err, lambda: SimConfig(**kw))
    cfg = SimConfig(**kw)
    err, j = _refusal(
        lambda: JaxOverlaySimulation(jcfg, use_pallas=False).run())
    if err is not None:
        return _same_refusal(
            err, lambda: OverlaySimulation(cfg, device="cpu").run())
    p = OverlaySimulation(cfg, device="cpu").run()
    for f in ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
              "send_hist", "joinreq", "joinrep"):
        assert np.array_equal(np.asarray(getattr(j.final_state, f)),
                              getattr(p.final_state, f).numpy()), f
    # the K4 and K5 routes report live_uncovered as -1 (not tracked)
    from gossip_protocol_tpu_torch.models.overlay_grid import grid_supported
    from gossip_protocol_tpu_torch.models.overlay_mega import mega_supported
    kernel_route = mega_supported(cfg) or grid_supported(cfg)
    for f in vars(p.metrics):
        if f == "live_uncovered" and kernel_route:
            assert (np.asarray(p.metrics.live_uncovered) == -1).all()
            continue
        assert np.array_equal(np.asarray(getattr(j.metrics, f)),
                              np.asarray(getattr(p.metrics, f))), f
