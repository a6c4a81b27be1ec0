"""The cells' path on the card at a moderate size: the port's fleets and
service against the plain references run on the card (the dense merge's
0/1 products in float16 there).  Run on a machine with an H100:

    python3 -m pytest benchmark/tests/test_benchmark_card.py -q
"""

import pytest
import torch

from benchmark.harness import run_cell

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90); none is visible")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the port's kernels are built for sm_90a")
    return "cuda"


@pytest.mark.parametrize("cell,over,traffic", [
    ("dense4096-drop.sweep8", dict(max_nnb=1024, total_ticks=320),
     dict(batch=4)),
    ("overlay65k-churn.sweep8", dict(max_nnb=4096, total_ticks=208),
     dict(batch=4)),
    ("overlay65k-churn.served", dict(max_nnb=4096, total_ticks=208),
     dict(max_batch=4, rate_rps=6.0))])
def test_cells_on_the_card_at_a_moderate_size(cuda, cell, over, traffic):
    out = run_cell(cell, 2 ** 32 + 19, 3.0, False, device=cuda,
                   conf_over=over, traffic_over=traffic, log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
