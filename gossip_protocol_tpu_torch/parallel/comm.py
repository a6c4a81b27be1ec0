"""Communication backends of the dense tick (port of
``gossip_protocol_tpu/parallel/comm.py``).

The tick (core/tick.py ``_composable_phases``) is written once against
this interface:

* :class:`LocalComm` — one device; a transpose is a transpose and the
  merge is one ``masked_max3`` call over the whole N x N block.
* :class:`RingComm` — the peer axis, and with it every row of the
  (N, N) tables, is split over one axis of a port mesh
  (parallel/mesh.py) inside ``shard_map``.  Delivery becomes one
  ``all_to_all`` (sender-major to receiver-major) and the gossip merge a
  **ring reduction**: payload row blocks rotate around the axis with
  ``ppermute`` while each shard max-accumulates the ``masked_max3`` of
  its receivers against the block it holds, an Nl x Nl delivery block
  against Nl x N payload rows (the kernel's rectangular form).

Tensors may carry a leading lane axis (a fleet on a 2-D lanes x peers
mesh, parallel/fleet_mesh.py): the row axis of a plane is its
second-to-last dimension and of a vector its last.
"""

from __future__ import annotations

import torch

from ..ops.merge import masked_max3
from .mesh import ctx


def _merge(deliver_sr, known, hb, ts, now: int, t_remove: int):
    """``masked_max3`` of a sender-major delivery block, every receiver
    processing (delivery is already gated)."""
    proc = torch.ones(deliver_sr.shape[:-2] + deliver_sr.shape[-1:],
                      dtype=torch.bool, device=deliver_sr.device)
    return masked_max3(deliver_sr.contiguous(), proc, known.contiguous(),
                       hb.contiguous(), ts.contiguous(), now,
                       t_remove=t_remove)


class LocalComm:
    """Single-device execution: every row is local, collectives are
    identities."""

    n_shards = 1

    def row_ids(self, n: int, device) -> torch.Tensor:
        """Global ids of the locally held rows."""
        return torch.arange(n, device=device)

    def rows_of(self, v):
        """A replicated per-peer vector ``[..., N]`` at the local rows."""
        return v

    def slice_rows(self, x):
        """A replicated plane ``[..., N, M]`` at the local rows."""
        return x

    def transpose(self, x):
        """``[..., rows=senders, N] -> [..., rows=receivers, N]``."""
        return x.transpose(-1, -2)

    def or_across(self, v):
        """OR of per-shard partial vectors (identity on one shard)."""
        return v

    def gather_rows(self, v_local):
        """``[..., local rows] -> [..., N]``."""
        return v_local

    def merge_reduce(self, recv_from, known, hb, ts, now: int, *,
                     t_remove: int):
        """The three merge maxima ``[..., rows=receivers, N]`` of
        ``recv_from`` (receiver-major) against the senders' rows."""
        return _merge(recv_from.transpose(-1, -2), known, hb, ts, now,
                      t_remove)


class RingComm:
    """Peer-axis-sharded execution inside a :func:`~.mesh.shard_map`
    body: every (N, N) table split on its rows over ``axis``, every
    (N,) vector replicated.  N must divide by the axis size."""

    def __init__(self, axis_name: str, n_shards: int):
        self.axis = axis_name
        self.n_shards = n_shards

    def _nl(self, n: int) -> int:
        if n % self.n_shards:
            raise ValueError(f"peer count {n} does not divide over the "
                             f"{self.n_shards}-entry {self.axis!r} axis")
        return n // self.n_shards

    def row_start(self, n: int) -> int:
        return ctx().axis_index(self.axis) * self._nl(n)

    def row_ids(self, n: int, device) -> torch.Tensor:
        return torch.arange(self._nl(n), device=device) + self.row_start(n)

    def rows_of(self, v):
        n = v.shape[-1]
        r0 = self.row_start(n)
        return v[..., r0:r0 + self._nl(n)]

    def slice_rows(self, x):
        n = x.shape[-2]
        r0 = self.row_start(n)
        return x[..., r0:r0 + self._nl(n), :]

    def transpose(self, x):
        """Distributed transpose: sender-row-sharded ``[..., Nl, N]`` ->
        receiver-row-sharded ``[..., Nl, N]`` by one ``all_to_all``."""
        nl, n = x.shape[-2:]
        p = self.n_shards
        # per-destination blocks on a new leading axis: [P, ..., Nl_s, Nl_r]
        blocks = x.unflatten(-1, (p, nl)).movedim(-2, 0)
        w = ctx().all_to_all(blocks, self.axis)    # block o = x_o[.., mine]
        # out[..., r, o * Nl + s] = w[o, ..., s, r]
        lead = w.dim() - 3
        w = w.movedim(0, -1)                       # [..., S, R, P]
        w = w.permute(*range(lead), lead + 1, lead + 2, lead)
        return w.reshape(x.shape)

    def or_across(self, v):
        return ctx().psum(v.to(torch.bool), self.axis)

    def gather_rows(self, v_local):
        return ctx().all_gather(v_local, self.axis, dim=-1)

    def merge_reduce(self, recv_from, known, hb, ts, now: int, *,
                     t_remove: int):
        """Ring max-accumulation over rotating payload blocks
        (``comm.py:130-165``): at step k this shard holds the rows of
        origin ``o = (me - k) mod P`` and merges its receivers' column
        block ``o`` of ``recv_from`` against them, then passes the block
        to ``me + 1``.

        recv_from: ``[..., Nl_r, N]`` local receiver rows (post-transpose).
        known / hb / ts: ``[..., Nl, N]`` this shard's payload rows.
        """
        c = ctx()
        nl = known.shape[-2]
        p = self.n_shards
        me = c.axis_index(self.axis)
        perm = [(i, (i + 1) % p) for i in range(p)]
        kb, hbb, tsb = known, hb, ts
        acc = None
        for k in range(p):
            o = (me - k) % p
            block = recv_from[..., o * nl:(o + 1) * nl].transpose(-1, -2)
            r = _merge(block, kb, hbb, tsb, now, t_remove)
            acc = r if acc is None else tuple(
                torch.maximum(a, b) for a, b in zip(acc, r))
            if k + 1 < p:     # the three planes ride one exchange
                kb, hbb, tsb = c.ppermute((kb, hbb, tsb), self.axis, perm)
        return acc
