"""Open-loop arrivals and the saturation rule: the yardstick's own copy
of the port's generator (``gossip_protocol_tpu_torch/service/traffic.py``
Poisson ``TrafficPattern``, ``make_schedule``'s per-index draws) and
of its load bench's rule (``service/loadbench.py`` ``_saturated``), so
a change to the program cannot move them.

Arrival ``i``'s draws come from a fresh ``default_rng((seed, i))``: its
gap is an exponential at the mix's rate (``-log1p(-u) / rate``, as
``make_schedule`` draws it).  A run takes the gaps that fill its window
from the mix's fixed ``arrival_seed`` and starts the sequence at an
offset drawn from the run's seed, wrapping round: every seed offers the
same gaps, with the same clusters, in another order, so a tail does not
swing with the seed.  Each request's lane seed comes from the run's
seed.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

#: a load point saturates when it completes less than this share of its
#: offered rate (loadbench.py SATURATION_FRAC)...
SATURATION_FRAC = 0.9
#: ...and its makespan overran the arrivals' span by this factor: the
#: backlog outlived the arrivals (loadbench.py SATURATION_SPAN_RATIO)
SATURATION_SPAN_RATIO = 1.2


def gap_unit(arrival_seed: int, i: int) -> float:
    """Unit exponential gap of arrival ``i`` (1-based; ``make_schedule``'s
    first draw of its per-index generator)."""
    return -math.log1p(-np.random.default_rng((arrival_seed, i)).random())


def schedule(rate_rps: float, seconds: float, arrival_seed: int,
             seed: int) -> list[tuple[float, int]]:
    """``(due_s, lane_seed)`` of every arrival due in ``[0, seconds)``:
    the mix's gaps in the run's order, at ``rate_rps``."""
    if rate_rps <= 0.0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    units, t = [], 0.0
    while True:                 # the mix's own gaps that fill the window
        u = gap_unit(arrival_seed, len(units) + 1)
        t += u / rate_rps
        if t >= seconds:
            break
        units.append(u)
    rng = np.random.default_rng((seed, 0))
    off = int(rng.integers(0, max(1, len(units))))
    out, t = [], 0.0
    for j in list(range(off, len(units))) + list(range(off)):
        t += units[j] / rate_rps
        if t >= seconds:
            break
        out.append((t, int(rng.integers(1, 1 << 31))))
    return out


def saturated(offered_rps: float, achieved_rps: float, wall_s: float,
              span_s: float, frac: float = SATURATION_FRAC,
              span_ratio: float = SATURATION_SPAN_RATIO) -> bool:
    """loadbench.py ``_saturated``: completes less than ``frac`` of the
    offered rate AND the run outlived the arrivals by ``span_ratio``."""
    return achieved_rps < frac * offered_rps and wall_s > span_ratio * span_s


def percentile(values, q: float) -> Optional[float]:
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))
