"""The port's copies of the JAX-free modules agree with the originals:
config parsing, the injection schedule, the shared hash PRNGs and the
address helpers.  Exact equality throughout."""

import os

import numpy as np
import pytest
import torch

from gossip_protocol_tpu import addressing as jax_addressing
from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.state import make_schedule_host as jax_schedule
from gossip_protocol_tpu.utils import hash32 as jax_hash32
from gossip_protocol_tpu.utils import prng as jax_prng
from gossip_protocol_tpu_torch import addressing
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.state import make_schedule, make_schedule_host
from gossip_protocol_tpu_torch.utils import hash32, prng
from tests.conftest import TESTCASES

torch.set_num_threads(2)

SCENARIOS = ("singlefailure", "multifailure", "msgdropsinglefailure")


@pytest.mark.parametrize("name", SCENARIOS)
def test_from_conf_to_dict(name):
    path = os.path.join(TESTCASES, f"{name}.conf")
    assert SimConfig.from_conf(path).to_dict() \
        == JaxConfig.from_conf(path).to_dict()
    kw = dict(max_nnb=777, seed=9, total_ticks=300, rejoin_after=40)
    assert SimConfig.from_conf(path, **kw).to_dict() \
        == JaxConfig.from_conf(path, **kw).to_dict()


SCHEDULE_CASES = [
    dict(max_nnb=10),
    dict(max_nnb=10, single_failure=False),
    dict(max_nnb=64, single_failure=False, seed=4),
    dict(max_nnb=100, drop_msg=True, msg_drop_prob=0.25, seed=11,
         drop_open_tick=20, drop_close_tick=90, total_ticks=120),
    dict(max_nnb=48, seed=2, fail_tick=30, rejoin_after=25),
    dict(max_nnb=4096, single_failure=False, seed=0, total_ticks=200),
]


@pytest.mark.parametrize("kw", SCHEDULE_CASES)
def test_make_schedule_host(kw):
    want = jax_schedule(JaxConfig(**kw))
    got = make_schedule_host(SimConfig(**kw))
    for name in ("start_tick", "fail_tick", "rejoin_tick", "drop_active"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.drop_prob == want.drop_prob
    assert got.drop_open == int(want.drop_open)
    assert got.drop_close == int(want.drop_close)
    on_dev = make_schedule(SimConfig(**kw), device="cpu")
    assert torch.equal(on_dev.fail_tick, torch.from_numpy(got.fail_tick))


def test_hash_prngs_key_sweep():
    rng = np.random.default_rng(0)
    for _ in range(200):
        seed, a, b, c, d = (int(x) for x in rng.integers(0, 2**31, 5))
        assert prng.hash_uniform(seed, a, b, c, d) \
            == jax_prng.hash_uniform(seed, a, b, c, d)
        assert prng.fail_schedule_uniform(seed) \
            == jax_prng.fail_schedule_uniform(seed)
    keys = [rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
            for _ in range(5)]
    for k in range(6):
        got = hash32.mix32(np.uint32(12345), *keys[:k])
        want = jax_hash32.mix32(np.uint32(12345), *keys[:k])
        assert np.array_equal(got, want), k
    for p in (0.0, 0.1, 0.25, 0.5, 1.0, 1e-9):
        assert hash32.threshold32(p) == jax_hash32.threshold32(p)


def test_addressing():
    for i in (0, 1, 9, 255, 256, 4095, 65535):
        assert addressing.addr_str(i) == jax_addressing.addr_str(i)
        assert addressing.display_addr(i) == jax_addressing.display_addr(i)
        s = addressing.addr_str(i)
        assert addressing.parse_addr(s) == jax_addressing.parse_addr(s) == i


@pytest.mark.parametrize("kw", [dict(model="overlay", flap_rate=0.25),
                                dict(partition_groups=2,
                                     partition_open_tick=10,
                                     partition_close_tick=50),
                                dict(zombie=True)])
def test_unported_configs_raise(kw):
    with pytest.raises(NotImplementedError):
        SimConfig(max_nnb=16, **kw)
