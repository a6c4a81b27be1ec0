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


def _k1_inputs(n, seed, dev):
    rng = np.random.default_rng(seed)

    def b(p, shape):
        return torch.from_numpy(rng.random(shape) < p).to(dev)

    def i(lo, hi, shape):
        return torch.from_numpy(
            rng.integers(lo, hi, shape, dtype=np.int32)).to(dev)

    return (b(0.6, (n, n)), b(0.9, n), b(0.7, (n, n)), i(0, 400, (n, n)),
            i(T - 40, T + 1, (n, n))), dict(
        gdrop=b(0.1, (n, n)), ops=b(0.85, n), jrep=b(0.2, n),
        jreq=b(0.2, n), live_hold=b(0.1, n))


@pytest.mark.parametrize("n", (10, 64, 100, 333))
def test_masked_max3_and_epilogue_kernels(dev, n):
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import (
        tick_epilogue, tick_epilogue_plain)
    from gossip_protocol_tpu_torch.ops.merge import (masked_max3,
                                                     masked_max3_plain)
    (gossip, proc, known, hb, ts), v = _k1_inputs(n, n, dev)
    before = masked_max3.launches
    m = masked_max3(gossip, proc, known, hb, ts, T, t_remove=T_REMOVE)
    assert masked_max3.launches == before + 1
    m_p = masked_max3_plain(gossip, proc, known, hb, ts, T,
                            t_remove=T_REMOVE)
    for a, b in zip(m, m_p):
        assert torch.equal(a, b)
    for ev in (True, False):
        args = (*m, gossip, proc, known, hb, ts, v["gdrop"], v["ops"],
                v["jrep"], v["jreq"], v["live_hold"], T)
        got = tick_epilogue(*args, t_remove=T_REMOVE, with_events=ev)
        want = tick_epilogue_plain(*args, t_remove=T_REMOVE, with_events=ev)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("n,s_ticks", ((16, 16), (64, 16), (200, 8)))
def test_dense_mega_kernel(dev, n, s_ticks):
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import (
        dense_mega_ticks, dense_mega_ticks_plain)
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
    for ev, rj in ((True, True), (False, False)):
        kw = dict(n=n, s_ticks=s_ticks, t_remove=T_REMOVE, can_rejoin=rj,
                  with_events=ev)
        got = dense_mega_ticks(**x, sp=t0, **kw)
        want = dense_mega_ticks_plain(**x, sp=t0, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


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
