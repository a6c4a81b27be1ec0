"""The port's scenario catalog, dense families, against the live JAX package.

One seed of every dense family: the port's ``run_solo`` (a trace-mode
``Simulation`` run on the CPU, the kernels' plain versions) and the JAX
package's ``run_solo`` give the same oracle verdict, a pass, and the
same lane digest (final tables and the removal masks).  More seeds run
under ``slow``.
"""

import pytest
import torch

from gossip_protocol_tpu.models import scenarios as jax_scenarios
from gossip_protocol_tpu_torch.models import scenarios

torch.set_num_threads(2)

DENSE = sorted(n for n in scenarios.CATALOG if n.startswith("dense"))


def test_catalog_equals_jax():
    """Same families, claims, worlds and variant order as the JAX
    catalog; every family's config equal field for field."""
    assert sorted(scenarios.CATALOG) == sorted(jax_scenarios.CATALOG)
    for name, fam in scenarios.CATALOG.items():
        jfam = jax_scenarios.CATALOG[name]
        assert (fam.claim, fam.world) == (jfam.claim, jfam.world), name
        assert fam.build(1000).to_dict() == jfam.build(1000).to_dict()
    got = [(f.name, s) for f, s in scenarios.variants(seeds_per_family=3)]
    want = [(f.name, s) for f, s in
            jax_scenarios.variants(seeds_per_family=3)]
    assert got == want
    assert scenarios.repro_command("dense_wave", 1003).count("1003") == 1
    # the sweep no longer waits for the service: it runs on the card by
    # default (raising where there is none) and on the CPU when asked
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            scenarios.sweep()
    rep = scenarios.sweep(families=["dense_asym_drop"], seeds_per_family=1,
                          device="cpu")
    assert rep["variants"] == 1 and rep["failed"] == 0


@pytest.mark.parametrize("name", DENSE)
def test_dense_family_equals_jax(name):
    want = jax_scenarios.run_solo(name, 1000)
    got = scenarios.run_solo(name, 1000, device="cpu")
    assert got == want
    assert got[0] == [], got[0][:3]


@pytest.mark.slow
@pytest.mark.parametrize("seed", (1001, 1002, 1003))
@pytest.mark.parametrize("name", DENSE)
def test_dense_family_more_seeds(name, seed):
    assert scenarios.run_solo(name, seed, device="cpu") \
        == jax_scenarios.run_solo(name, seed)
