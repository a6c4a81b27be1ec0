"""The port's scenario catalog, overlay families, against the live JAX package.

One seed of every overlay family: the port's ``run_solo`` (an
``OverlaySimulation`` run on the CPU through the worlds' per-tick
exchange) and the JAX package's ``run_solo`` (its XLA tick) give the
same oracle verdict, a pass, and the same lane digest (the final view
tables, in_group and own heartbeats).  More seeds run under ``slow``.
"""

import pytest
import torch

from gossip_protocol_tpu.models import scenarios as jax_scenarios
from gossip_protocol_tpu_torch.models import scenarios

torch.set_num_threads(2)

OVERLAY = sorted(n for n in scenarios.CATALOG if n.startswith("overlay"))


@pytest.mark.parametrize("name", OVERLAY)
def test_overlay_family_equals_jax(name):
    want = jax_scenarios.run_solo(name, 1000)
    got = scenarios.run_solo(name, 1000, device="cpu")
    assert got == want
    assert got[0] == [], got[0][:3]


@pytest.mark.slow
@pytest.mark.parametrize("seed", (1001, 1002, 1003))
@pytest.mark.parametrize("name", OVERLAY)
def test_overlay_family_more_seeds(name, seed):
    assert scenarios.run_solo(name, seed, device="cpu") \
        == jax_scenarios.run_solo(name, seed)
