"""Gossip merge reductions (counterpart of ``gossip_protocol_tpu/ops/merge.py``).

The whole receive-and-merge phase of one tick is three masked maxima
over the sender axis:

    M[r, j] = max over s of  payload[s, j]  where  recv_from[r, s]

with the payloads shifted up by one (``a1 = known ? hb + 1 : 0``, and
the fresh-only ``f1``/``t1``), so that "no contributing sender" is 0
before and ``FILL = -1`` after shifting back down.  That contract is
the JAX package's ``gossip_reductions``.

:func:`masked_max3` is the tick's entry: it reads the delivery mask as
``gossip[s, r] & proc[r]`` (sender-major, as the state holds it), so no
transposed copy is made.  On a CUDA tensor it launches the
``masked_max3`` kernel (csrc/dense_tick.cu), which replaces the TPU's
MXU level descent (``gossip_reductions_mxu`` / ``_masked_max_mxu``)
with a tiled integer product-max; on a CPU tensor it runs
:func:`masked_max3_plain`.  Both are exact, so they agree bit for bit.
"""

from __future__ import annotations

import torch

FILL = -1

#: element budget of one product-max block in the plain version
_PLAIN_BLOCK_ELEMS = 1 << 24


def merge_payloads(known, hb, ts, now: int, t_remove: int):
    """Shift-encoded payload planes ``(a1, f1, t1)``, i32[S, J]."""
    k = known.to(torch.int32)
    fresh = k * (now - ts < t_remove)
    return k * (hb + 1), fresh * (hb + 1), fresh * (ts + 1)


def masked_max3_plain(gossip, proc, known, hb, ts, now: int, *,
                      t_remove: int):
    """Plain PyTorch version of the ``masked_max3`` kernel: a blockwise
    product-max over the sender axis.  Returns ``(m_all, m_fresh,
    t_fresh)`` i32[N, N] (FILL where no sender contributes)."""
    n = known.shape[0]
    recv_from = (gossip & proc[None, :]).t()           # [r, s]
    a1, f1, t1 = merge_payloads(known, hb, ts, now, t_remove)
    b = max(1, min(n, _PLAIN_BLOCK_ELEMS // max(1, n * n)))
    m = [torch.zeros((n, n), dtype=torch.int32, device=known.device)
         for _ in range(3)]
    zero = torch.zeros((), dtype=torch.int32, device=known.device)
    for s0 in range(0, n, b):
        d = recv_from[:, s0:s0 + b, None]                # [R, B, 1]
        for acc, v in zip(m, (a1, f1, t1)):
            blk = torch.where(d, v[None, s0:s0 + b, :], zero).amax(1)
            torch.maximum(acc, blk, out=acc)
    return m[0] - 1, m[1] - 1, m[2] - 1


def masked_max3(gossip, proc, known, hb, ts, now: int, *, t_remove: int):
    """The three merge maxima of one tick (see the module docstring).

    ``gossip`` bool[N, N] (sender, receiver), ``proc`` bool[N] (which
    receivers consume this tick), ``known`` bool / ``hb``, ``ts`` i32
    [N, N] the senders' rows.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise).
    """
    if known.device.type == "cpu":
        return masked_max3_plain(gossip, proc, known, hb, ts, now,
                                 t_remove=t_remove)
    from .cuda._build import check, check_args, library, ptr, stream_ptr
    n = known.shape[0]
    plane = (n, n)
    check_args("masked_max3", (gossip, torch.bool, plane),
               (proc, torch.bool, (n,)), (known, torch.bool, plane),
               (hb, torch.int32, plane), (ts, torch.int32, plane))
    m_all, m_fresh, t_fresh = (torch.empty((n, n), dtype=torch.int32,
                                           device=known.device)
                               for _ in range(3))
    code = library().gp_masked_max3(
        ptr(gossip), ptr(proc), ptr(known), ptr(hb), ptr(ts),
        ptr(m_all), ptr(m_fresh), ptr(t_fresh), n, int(now), int(t_remove),
        stream_ptr(known.device))
    masked_max3.launches += 1
    check(code, "masked_max3")
    return m_all, m_fresh, t_fresh


masked_max3.launches = 0
