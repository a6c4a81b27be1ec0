"""The port's overlay schedule, dims, hashes and masks equal the JAX
package's (exact equality).  All of them are closed-form vector
functions of (seed, id, tick), so the BASELINE shapes are checked at
their full N, 2^20 included."""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.models import overlay as jov
from gossip_protocol_tpu.models.overlay_mega import \
    mega_supported as jax_mega_supported
from gossip_protocol_tpu.utils.hash32 import mix32 as jax_mix32
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import overlay as pov
from gossip_protocol_tpu_torch.models.overlay_mega import mega_supported
from gossip_protocol_tpu_torch.ops import overlay_rules as rules
from gossip_protocol_tpu_torch.utils.hash32 import mix32_t

torch.set_num_threads(2)

SCENARIOS = {
    "ramp_fail": dict(max_nnb=64, single_failure=True, seed=3,
                      total_ticks=120, fail_tick=40, step_rate=0.5),
    "drop": dict(max_nnb=128, single_failure=True, drop_msg=True,
                 msg_drop_prob=0.3, seed=5, total_ticks=120, fail_tick=60,
                 step_rate=0.25, drop_open_tick=10, drop_close_tick=100),
    "churn": dict(max_nnb=64, single_failure=False, seed=7,
                  total_ticks=200, churn_rate=0.25, rejoin_after=30,
                  step_rate=40.0 / 64),
    "powerlaw": dict(max_nnb=64, single_failure=True, seed=9,
                     total_ticks=120, fail_tick=50, step_rate=0.5,
                     topology="powerlaw", fanout=5),
    "multi_rejoin": dict(max_nnb=32, single_failure=False, seed=11,
                         total_ticks=90, fail_tick=30, rejoin_after=25),
    "wide_view": dict(max_nnb=64, seed=3, overlay_view=16, fanout=4),
    # the three BASELINE overlay shapes (bench.py:319-349, 936-937)
    "n4096_drop": dict(max_nnb=4096, single_failure=True, drop_msg=True,
                       msg_drop_prob=0.1, seed=0, total_ticks=608,
                       fail_tick=304, step_rate=40.0 / 4096),
    "n65536_churn": dict(max_nnb=65536, single_failure=False, seed=0,
                         total_ticks=608, churn_rate=0.2, rejoin_after=40,
                         step_rate=64.0 / 65536),
    "n1m_powerlaw": dict(max_nnb=1 << 20, single_failure=True, seed=0,
                         total_ticks=272, fail_tick=136,
                         step_rate=40.0 / (1 << 20), topology="powerlaw"),
}


def _pair(name):
    kw = dict(model="overlay", **SCENARIOS[name])
    return JaxConfig(**kw), SimConfig(**kw)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_dims_thresholds_and_schedule_fields(name):
    jc, pc = _pair(name)
    assert pov.resolved_dims(pc) == jov.resolved_dims(jc)
    k, f = pov.resolved_dims(pc)
    assert np.array_equal(pov.degree_thresholds(pc, f),
                          jov.degree_thresholds(jc, f))
    assert mega_supported(pc) == jax_mega_supported(jc)
    js = jov.make_overlay_schedule(jc)
    ps = pov.make_overlay_schedule(pc)
    import dataclasses
    jfields = {f.name for f in dataclasses.fields(js)}
    assert jfields == {f.name for f in dataclasses.fields(ps)}
    for field in jfields:
        want = np.asarray(getattr(js, field))
        got = np.asarray(getattr(ps, field))
        assert np.array_equal(got.astype(np.int64),
                              want.astype(np.int64)), field


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_per_id_schedule_columns(name):
    jc, pc = _pair(name)
    js = jov.make_overlay_schedule(jc)
    ps = pov.make_overlay_schedule(pc)
    n = jc.n
    ids = np.arange(n, dtype=np.int32)
    cols = pov.schedule_columns(ps, n, "cpu")
    assert np.array_equal(cols.start.numpy(), np.asarray(js.start_of(ids)))
    assert np.array_equal(cols.fail.numpy(), np.asarray(js.fail_of(ids)))
    assert np.array_equal(cols.rejoin.numpy(),
                          np.asarray(js.rejoin_of(ids)))
    # the power-law out-degree draw of models/overlay_mega.py _pack_state
    du = jax_mix32(np.uint32(ps.seed), ids.astype(np.uint32),
                   np.uint32(rules._SALT_DEGREE))
    deg = 1 + (du[:, None] < np.asarray(js.deg_thr)[None, :]).sum(1)
    assert np.array_equal(cols.deg.numpy(), deg)
    for t in (0, jc.fail_tick, jc.fail_tick + 1, jc.total_ticks // 2):
        assert np.array_equal(ps.failed_at(torch.from_numpy(ids), t).numpy(),
                              np.asarray(js.failed_at(ids, t)))
        assert ps.drop_active(t) == bool(js.drop_active(t))


@pytest.mark.parametrize("n", (4, 32, 4096, 65536, 1 << 20))
def test_exchange_masks(n):
    for seed in (0, 7, 0xFFFFFFFF):
        for f in range(8):
            ts = np.arange(-1, 700, dtype=np.int32)
            want = np.asarray(jov.exchange_mask(np.uint32(seed), ts, f, n))
            got = [rules.exchange_mask(seed, int(t), f, n) for t in ts]
            assert np.array_equal(np.asarray(got), want)


@pytest.mark.parametrize("seed", (0, 1, 123456789, 0xFFFFFFFF))
def test_hash_keys_and_slots(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    ids = rng.integers(-1, 1 << 20, 4096).astype(np.int32)
    ts = rng.integers(-1, 4094, 4096).astype(np.int32)
    t_ids, t_ts = torch.from_numpy(ids), torch.from_numpy(ts)
    want = np.asarray(jov._pack_key(ids, ts)).astype(np.int64)
    assert np.array_equal(rules.pack_key(t_ids, t_ts).numpy(), want)
    for k in (16, 48, 64):
        want = np.asarray(jov._slot_of(np.uint32(seed), np.uint32(3),
                                       ids, k))
        assert np.array_equal(rules.slot_of(seed, 3, t_ids, k).numpy(), want)
    u = rng.integers(0, 1 << 32, (3, 4096), dtype=np.uint64).astype(np.uint32)
    want = jax_mix32(np.uint32(seed), u[0], u[1], u[2], np.uint32(5))
    got = mix32_t(seed, *(torch.from_numpy(x.astype(np.int64)) for x in u), 5)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
