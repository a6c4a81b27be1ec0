"""Message-loss injection (counterpart of ``gossip_protocol_tpu/ops/drop.py``).

Replaces ``EmulNet::ENsend``'s drop check (EmulNet.cpp:90-94).  One
(N+2, N) uniform draw covers every send class of a tick — gossip rows
(sender-major), the JOINREQ vector, the JOINREP vector — keyed by
``fold_in(rng, t)``.  The draw is the JAX package's threefry stream bit
for bit (utils/threefry.py), so both packages drop the same messages
from the same seed.  Outside the drop window no draw is made, as the
JAX ``lax.cond`` skips it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.threefry import fold_in, uniform


def tick_drop_masks(rng, t: int, n: int, active: bool, prob, device,
                    link_prob=None):
    """Per-tick drop decisions ``(gossip bool[N, N], joinreq bool[N],
    joinrep bool[N])`` for tick ``t``.

    ``rng`` is the run's uint32[2] key, ``active`` whether the drop
    window is open for this tick's sends (host bool), ``prob`` the
    float32 MSG_DROP_PROB.  ``link_prob`` (the asymmetric-drop world)
    is not ported and raises.
    """
    if link_prob is not None:
        raise NotImplementedError(
            "per-link drop probabilities (asym_drop world) are not yet "
            "ported to gossip_protocol_tpu_torch")
    if not active:
        drop = torch.zeros((n + 2, n), dtype=torch.bool, device=device)
    else:
        u = uniform(fold_in(rng, t), (n + 2, n), device)
        drop = u < float(np.float32(prob))
    return drop[:n], drop[n], drop[n + 1]
