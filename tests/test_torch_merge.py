"""The port's gossip merge maxima equal the JAX package's.

``gossip_protocol_tpu_torch.ops.merge`` keeps the FILL=-1 / +1-shift
contract of ``gossip_reductions`` (blockwise product-max) and
``gossip_reductions_mxu`` (level descent); on the CPU the
``masked_max3`` wrapper runs its plain version.  Exact equality.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.ops import merge as jax_merge
from gossip_protocol_tpu_torch.ops import merge

torch.set_num_threads(2)

T_REMOVE = 20
NOW = 300


def _inputs(n, seed, p_recv):
    rng = np.random.default_rng(seed)
    return dict(
        recv_from=rng.random((n, n)) < p_recv,
        known=rng.random((n, n)) < 0.7,
        hb=rng.integers(0, 400, (n, n), dtype=np.int32),
        # spans both sides of the freshness gate now - ts < t_remove
        ts=rng.integers(NOW - 2 * T_REMOVE, NOW + 1, (n, n), dtype=np.int32))


def _port(x):
    """The ``gossip_reductions`` contract through the port's merge: the
    sender-major delivery is ``recv_from.T`` with every receiver
    processing; ``any_fresh`` is ``m_ts_fresh >= 0``."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    deliver = t["recv_from"].t().contiguous()
    proc = torch.ones(deliver.shape[1], dtype=torch.bool)
    m_a, m_f, m_t = merge.masked_max3(deliver, proc, t["known"], t["hb"],
                                      t["ts"], NOW, t_remove=T_REMOVE)
    return m_a, m_f, m_t, m_t >= 0


@pytest.mark.parametrize("n", (10, 64, 100))
@pytest.mark.parametrize("p_recv", (0.0, 0.05, 0.6, 1.0))
def test_gossip_reductions_match(n, p_recv):
    x = _inputs(n, seed=n, p_recv=p_recv)
    got = [g.numpy() for g in _port(x)]
    args = (x["recv_from"], x["known"], x["hb"], x["ts"], np.int32(NOW))
    for ref in (jax_merge.gossip_reductions(*args, t_remove=T_REMOVE,
                                            block_size=32),
                jax_merge.gossip_reductions_mxu(*args, t_remove=T_REMOVE)):
        for a, b in zip(got, ref):
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_masked_max3_reads_delivery_sender_major():
    """``masked_max3(gossip, proc, ...)`` is the merge of the delivery
    ``recv_from = (gossip & proc[None, :]).T`` with no transposed copy."""
    n = 48
    rng = np.random.default_rng(1)
    x = _inputs(n, seed=2, p_recv=0.5)
    gossip = rng.random((n, n)) < 0.5
    proc = rng.random(n) < 0.8
    want = jax_merge.gossip_reductions(
        (gossip & proc[None, :]).T, x["known"], x["hb"], x["ts"],
        np.int32(NOW), t_remove=T_REMOVE)
    before = merge.masked_max3.launches
    got = merge.masked_max3(
        torch.from_numpy(gossip), torch.from_numpy(proc),
        torch.from_numpy(x["known"]), torch.from_numpy(x["hb"]),
        torch.from_numpy(x["ts"]), NOW, t_remove=T_REMOVE)
    assert merge.masked_max3.launches == before   # CPU: plain version
    for a, b in zip(got, want[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b))
