"""Canonical buckets on the port (service/canonical.py, core/fleet.py
``CanonicalFleetSimulation``) against exact solo runs and the JAX
package.

A canonical class pads its lanes' peers to a power-of-two rung, draws
each drop-on lane's stream at its real width inside the rung (the drop
draw reads asym thresholds at that corner and gates the partition over
the whole rung) and slices results back to the real ``n``.  Every lane
must equal its exact, unpadded solo run on the port and on the JAX
package, bit for bit, with one fleet program a class.  Sizes are the
JAX canonical tests' (tests/test_canonical.py): N <= 16.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.core.sim import Simulation as JaxSimulation
from gossip_protocol_tpu.service.canonical import \
    canonical_bucket_key as jax_canonical_key
from gossip_protocol_tpu.state import (make_schedule_host as
                                       jax_schedule_host,
                                       pad_schedule_host as jax_pad)
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.fleet import CanonicalFleetSimulation
from gossip_protocol_tpu_torch.service import FleetService, solo_execute
from gossip_protocol_tpu_torch.service.canonical import (
    CanonicalLegUnsupported, canonical_bucket_key, canonical_supported,
    ladder_rung)
from gossip_protocol_tpu_torch.state import (SCHED_ARRAYS,
                                             make_schedule_host,
                                             pad_schedule_host)

jr = importlib.import_module("gossip_protocol_tpu.service.replay")
pr = importlib.import_module("gossip_protocol_tpu_torch.service.replay")

torch.set_num_threads(2)
pytestmark = pytest.mark.service


def norm_key(k):
    """A key with every config in it as its dict (the two packages'
    SimConfig classes differ, their fields do not)."""
    if isinstance(k, tuple):
        return tuple(norm_key(x) for x in k)
    if dataclasses.is_dataclass(k):
        return ("cfg", tuple(sorted(k.to_dict().items())))
    return k


BASE = dict(single_failure=True, total_ticks=80, fail_tick=30)

#: canonical classes: every lane of a class shares one canonical key
CLASSES = {
    # the grader's non-power-of-two N=10 with drop, rung 16
    "drop10": [dict(BASE, max_nnb=10, drop_msg=True, msg_drop_prob=p,
                    drop_open_tick=o, drop_close_tick=41, seed=s)
               for p, o, s in ((0.1, 13, 1), (0.2, 15, 2), (0.1, 11, 3))],
    # drop-off lanes of three real widths share rung 16
    "mixed_n": [dict(BASE, max_nnb=n, seed=s)
                for n, s in ((10, 1), (12, 2), (13, 3))],
    # asym thresholds at the corner: real n=13 in rung 16
    "asym": [dict(BASE, max_nnb=13, drop_msg=True, msg_drop_prob=0.1,
                  asym_drop=True, drop_open_tick=10, drop_close_tick=60,
                  seed=s) for s in (1, 2, 3)],
    # partition + drop at n=12, per-lane drop windows
    "partition_drop": [dict(BASE, max_nnb=12, drop_msg=True,
                            msg_drop_prob=0.1, partition_groups=g,
                            partition_open_tick=20, partition_close_tick=50,
                            drop_open_tick=5 + s, drop_close_tick=60, seed=s)
                       for g, s in ((2, 1), (3, 2))],
    # flap operands differ a lane (period, down)
    "flap": [dict(BASE, max_nnb=12, flap_rate=0.3, flap_period=p,
                  flap_down=d, flap_open_tick=10, flap_close_tick=70, seed=s)
             for p, d, s in ((10, 3, 1), (12, 4, 2))],
    # the composable route at the rung: zombie + churn
    "zombie": [dict(BASE, max_nnb=12, single_failure=False, zombie=True,
                    rejoin_after=20, seed=s) for s in (1, 2)],
    # byz + latency operands jittered
    "byz_latency": [dict(BASE, max_nnb=12, byz_rate=r, byz_boost=b,
                         link_latency=2, seed=s)
                    for r, b, s in ((0.2, 8, 1), (0.3, 6, 2))],
}


def test_ladder_rung():
    assert [ladder_rung(n) for n in (1, 4, 5, 8, 10, 16, 17, 33, 900,
                                     1000)] \
        == [4, 4, 8, 8, 16, 16, 32, 64, 1024, 1024]


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_canonical_key_equals_jax_and_is_shared(name):
    keys = set()
    for kw in CLASSES[name]:
        k = canonical_bucket_key(SimConfig(**kw), "trace")
        assert norm_key(k) == norm_key(jax_canonical_key(JaxConfig(**kw),
                                                         "trace"))
        keys.add(k)
    assert len(keys) == 1 and next(iter(keys))[0] == "canon"


def test_canonical_falls_back_to_exact_keys():
    ov = SimConfig(max_nnb=64, model="overlay", total_ticks=48)
    d = SimConfig(max_nnb=10)
    assert not canonical_supported(ov, "trace")
    assert not canonical_supported(d, "bench")
    for c, m in ((ov, "trace"), (d, "bench")):
        assert norm_key(canonical_bucket_key(c, m)) == norm_key(
            jax_canonical_key(JaxConfig(**c.to_dict()), m))
        assert canonical_bucket_key(c, m)[0] != "canon"


@pytest.mark.parametrize("kw", [CLASSES["asym"][0],
                                CLASSES["byz_latency"][0],
                                CLASSES["flap"][1]])
def test_pad_schedule_host_equals_jax(kw):
    got = pad_schedule_host(make_schedule_host(SimConfig(**kw)), 16)
    want = jax_pad(jax_schedule_host(JaxConfig(**kw)), 16)
    for k in SCHED_ARRAYS:
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for f in ("drop_active", "drop_prob", "drop_open", "drop_close",
              "flap_period", "flap_down", "flap_close"):
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_canonical_lanes_equal_exact_solo_runs(name):
    """One service, canonical buckets: the class is one bucket and one
    build, and each lane equals its exact solo run (port and JAX)."""
    kws = CLASSES[name]
    svc = FleetService(max_batch=4, canonicalize=True, device="cpu")
    hs = [svc.submit(SimConfig(**kw)) for kw in kws]
    svc.drain()
    st = svc.stats()
    assert st["cache"]["buckets"] == 1 and st["cache"]["builds"] == 1
    assert st["failures"]["retries"] == 0 and not st["last_errors"]
    cls = next(iter(svc.cache.class_map().values()))
    assert 1 <= len(cls["members"]) <= len(kws)
    for kw, h in zip(kws, hs):
        lane = h.result()
        cfg = SimConfig(**kw)
        assert lane.added.shape == (cfg.total_ticks, cfg.n, cfg.n)
        assert lane.final_state.known.shape == (cfg.n, cfg.n)
        ref = solo_execute(cfg, "trace", "cpu")
        assert pr._mismatch(pr.Template("t", cfg), ref, lane) is None, kw
        assert pr.result_digest(lane) == jr.result_digest(
            JaxSimulation(JaxConfig(**kw)).run()), kw


def test_canonical_fleet_engine_and_refusals():
    """The engine directly: filler lanes are never unstacked, members
    of another class are refused, and the modes the class does not
    serve raise early and typed."""
    kws = CLASSES["mixed_n"]
    sim = CanonicalFleetSimulation(SimConfig(**kws[0]), device="cpu")
    assert sim.rung == 16 and sim.cfg.n == 16
    cfgs = [SimConfig(**kw) for kw in kws]
    res = sim.run(configs=cfgs + [cfgs[0]], n_real=3)
    assert len(res.lanes) == 3 and res.padded_batch == 4
    for c, lane in zip(cfgs, res.lanes):
        assert lane.sent.shape == (c.n, c.total_ticks)
    with pytest.raises(ValueError, match="not a member"):
        sim.run(configs=[SimConfig(**CLASSES["asym"][0])])
    with pytest.raises(CanonicalLegUnsupported):
        sim.run_leg(configs=cfgs, ticks=16)
    with pytest.raises(CanonicalLegUnsupported):
        FleetService(canonicalize=True, checkpoint_every=16, device="cpu")
    with pytest.raises(NotImplementedError):
        sim.run_bench(configs=cfgs)
    with pytest.raises(ValueError):
        CanonicalFleetSimulation(SimConfig(max_nnb=64, model="overlay"),
                                 device="cpu")


def test_canonical_mixed_stream_collapses():
    """A jittered mixed stream: exact keys make one bucket per variant,
    canonical keys one per class, with equal results."""
    kws = CLASSES["drop10"] + CLASSES["mixed_n"]
    exact = FleetService(max_batch=4, device="cpu")
    canon = FleetService(max_batch=4, canonicalize=True, device="cpu")
    he = [exact.submit(SimConfig(**kw)) for kw in kws]
    hc = [canon.submit(SimConfig(**kw)) for kw in kws]
    exact.drain()
    canon.drain()
    assert exact.stats()["cache"]["buckets"] > \
        canon.stats()["cache"]["buckets"] == 2
    for a, b in zip(he, hc):
        assert pr.result_digest(a.result()) == pr.result_digest(b.result())
    st = canon.stats()["cache"]
    assert st["class_member_buckets"] >= 4


def test_canonical_lane_is_host_sliced():
    """Filler peers never surface: the lane's state is the real n x n
    corner, and a dataclass copy of it compares equal field by field."""
    kw = CLASSES["asym"][0]
    sim = CanonicalFleetSimulation(SimConfig(**kw), device="cpu")
    lane = sim.run(seeds=[1, 2]).lanes[0]
    for f in dataclasses.fields(lane.final_state):
        v = getattr(lane.final_state, f.name)
        if torch.is_tensor(v):
            assert v.shape[0] == 13, f.name
