"""32-bit counter-based hashing (copy of ``gossip_protocol_tpu/utils/hash32.py``).

Kept as numpy: the port's slice uses it only on the host.  The text
below is the reference module's.

The overlay model (models/overlay.py) derives all of its per-tick
randomness — per-receiver slot assignment, gossip target draws, drop
decisions — from this pure integer hash instead of stateful PRNG keys.
That keeps the hot path at one fused integer expression per draw, and
because the function is a plain uint32 computation it runs bit-identically
under numpy, so the scalar oracle (testing/overlay_oracle.py) replays the
exact device randomness without any replay harness.

The mixer is the murmur3 fmix32 finalizer over a Weyl-sequence
accumulation of the keys (public-domain constants), a 32-bit sibling of
the splitmix64 construction in utils/prng.py / native/bus.cc.
"""

from __future__ import annotations

import numpy as np

# 0-d arrays, not numpy scalars: unsigned wraparound is the point of
# the construction, and numpy warns on scalar (but not array) overflow
_GOLD = tuple(np.asarray(g, np.uint32) for g in
              (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1))
_ONE = np.asarray(1, np.uint32)
_M1 = np.asarray(0x7FEB352D, np.uint32)
_M2 = np.asarray(0x846CA68B, np.uint32)


def _u32(v):
    if isinstance(v, (int, np.integer)) or (isinstance(v, np.generic)):
        return np.asarray(v, np.uint32)
    return v


def mix32(seed, *keys):
    """uint32 hash of up to five integer keys (arrays broadcast).

    Works on jax arrays and numpy arrays alike: every operation is
    uint32 (wrapping) arithmetic, with the constants pre-typed as
    numpy uint32 scalars so neither backend widens or overflows.
    Array inputs must already be uint32.
    """
    with np.errstate(over="ignore"):   # unsigned wraparound is intended
        x = _u32(seed)
        for k, g in zip(keys, _GOLD):
            x = x + (_u32(k) + _ONE) * g
        x = (x ^ (x >> 16)) * _M1
        x = (x ^ (x >> 15)) * _M2
        x = x ^ (x >> 16)
    return x


def threshold32(prob: float) -> int:
    """uint32 threshold so that ``mix32(...) < threshold32(p)`` is a
    Bernoulli(p) draw.  Integer comparison keeps device (float32) and
    oracle (float64) behavior bit-identical — no float round-off at the
    decision boundary."""
    return min(0xFFFFFFFF, max(0, int(round(prob * 4294967296.0))))
