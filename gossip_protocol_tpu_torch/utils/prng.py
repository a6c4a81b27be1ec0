"""Counter-based PRNG shared with the native runtime (copy of
``gossip_protocol_tpu/utils/prng.py``).

``hash_uniform`` is the bit-exact Python twin of ``gossip::HashUniform``
(native/bus.cc): key material mixed with odd constants, then the
splitmix64 finalizer (public-domain Stafford/Steele mixing constants),
mapped to [0, 1) through the 53-bit double mantissa.  Both backends
derive scenario randomness (failure-victim selection, standalone drop
decisions) from this function, so the same seed produces the same
schedule whether the run executes on the JAX engine or the C++ engine —
unlike the reference, whose ``srand(time(NULL))`` (Application.cpp:50)
makes runs irreproducible even on one backend.

The device-side drop masks come from the threefry stream
(utils/threefry.py, bit-identical to ``jax.random``) — this module
seeds *host-side* schedule decisions only.
"""

from __future__ import annotations

_M64 = (1 << 64) - 1


def hash_uniform(seed: int, a: int, b: int, c: int, d: int) -> float:
    """Uniform double in [0, 1), a pure function of the five keys."""
    x = seed & _M64
    x = (x + 0x9E3779B97F4A7C15 * (a + 1)) & _M64
    x = (x + 0xBF58476D1CE4E5B9 * (b + 1)) & _M64
    x = (x + 0x94D049BB133111EB * (c + 1)) & _M64
    x = (x + 0xD6E8FEB86659FD93 * (d + 1)) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return (x >> 11) * (2.0 ** -53)


#: Salt for the failure-schedule draw (native/engine.cc uses the same).
FAIL_SALT = 7


def fail_schedule_uniform(seed: int) -> float:
    """The single uniform draw both backends use to pick failure victims."""
    return hash_uniform(seed, 0, 0, 0, FAIL_SALT)
