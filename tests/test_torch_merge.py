"""The port's gossip merge maxima equal the JAX package's.

``gossip_protocol_tpu_torch.ops.merge`` keeps the FILL=-1 / +1-shift
contract of ``gossip_reductions`` (blockwise product-max) and
``gossip_reductions_mxu`` (level descent); on the CPU the
``masked_max3`` wrapper runs its plain version, and
``masked_max3_descent`` mirrors the CUDA kernel's tile-local descent
(the kernel itself runs only on the card: tests/test_torch_cuda.py).
Exact equality.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.ops import merge as jax_merge
from gossip_protocol_tpu_torch.ops import merge
from test_torch_merge_cases import CASES, NOW, T_REMOVE, merge_case

torch.set_num_threads(2)


def _inputs(n, seed, p_recv):
    rng = np.random.default_rng(seed)
    return dict(
        recv_from=rng.random((n, n)) < p_recv,
        known=rng.random((n, n)) < 0.7,
        hb=rng.integers(0, 400, (n, n), dtype=np.int32),
        # spans both sides of the freshness gate now - ts < t_remove
        ts=rng.integers(NOW - 2 * T_REMOVE, NOW + 1, (n, n), dtype=np.int32))


@pytest.mark.parametrize("n", (10, 64, 100))
@pytest.mark.parametrize("p_recv", (0.0, 0.05, 0.6, 1.0) + CASES)
def test_gossip_reductions_match(n, p_recv):
    """The port's merge (the plain version, as the CPU wrapper runs it)
    and the plain mirror of the kernel's level descent equal both JAX
    merges; the descent runs no product without a delivery and at least
    the pre-resolve where there is one."""
    gossip, proc, known, hb, ts = merge_case(p_recv, n, seed=n)
    recv_from = (gossip & proc[None, :]).T
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (gossip, proc, known, hb, ts)]
    m = merge.masked_max3(*t, NOW, t_remove=T_REMOVE)
    m_d, levels = merge.masked_max3_descent(*t, NOW, t_remove=T_REMOVE)
    args = (recv_from, known, hb, ts, np.int32(NOW))
    for ref in (jax_merge.gossip_reductions(*args, t_remove=T_REMOVE,
                                            block_size=32),
                jax_merge.gossip_reductions_mxu(*args, t_remove=T_REMOVE)):
        for got in (m, m_d):
            for a, b in zip((*got, got[2] >= 0), ref):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype and np.array_equal(
                    a.numpy(), b)
    for lv in levels.values():
        assert lv.shape == (-(-n // merge.TILE_ROWS),
                            -(-n // merge.TILE_COLS))
        assert (lv == 0).all() if not recv_from.any() else (lv >= 1).any()


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
