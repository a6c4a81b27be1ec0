"""32-bit counter-based hashing (copy of ``gossip_protocol_tpu/utils/hash32.py``).

:func:`mix32` is the numpy original (host draws: the overlay's XOR
masks, the schedule).  :func:`mix32_t` is its torch twin for tensors on
either device: torch has no logical ``>>`` on uint32 on the CPU, so the
values ride int64 tensors masked to 32 bits, and each 32x32-bit product
is split in two 16-bit halves so that no int64 product overflows.  The
CUDA kernels (csrc/overlay_tick.cu) compute the same hash in
``uint32_t``.  The text below is the reference module's.

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


MASK32 = 0xFFFFFFFF
_GOLD_INT = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1)


def _mul32(x, c: int):
    """``x * c mod 2^32`` for ``x`` in [0, 2^33) (int or int64 tensor)."""
    if isinstance(x, int):
        return (x * c) & MASK32
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def mix32_t(seed, *keys):
    """:func:`mix32` on int64 tensors holding uint32 values (python ints
    broadcast); returns an int64 tensor in [0, 2^32)."""
    x = seed & MASK32
    for k, g in zip(keys, _GOLD_INT):
        x = (x + _mul32(k + 1, g)) & MASK32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)
