"""Counter-based draws the protocol's semantics are defined by, written
out plainly for the reference (no import of the program).

* :func:`hash_uniform` picks the failure victims from the seed (the
  splitmix64 finalizer over five keys, mapped to [0, 1) through a
  53-bit mantissa).
* :func:`fold_in` / :func:`uniform` are threefry-2x32 (20 rounds) in
  the layout of ``jax.random`` with partitionable counters: the dense
  model's message drops are ``uniform(fold_in(key, t), (n + 2, n)) <
  p`` with ``key = (0, seed mod 2^32)``.
* :func:`mix32` is the murmur3 fmix32 finalizer over a Weyl sum of up to
  five keys: the overlay's schedule, slots, exchange partners and drops.

uint32 words ride int64 tensors masked to 32 bits, since torch has no
logical right shift on uint32 on every device.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
#: "never" for a fail or rejoin tick (int32 max)
NEVER = 2 ** 31 - 1


def hash_uniform(seed: int, a: int, b: int, c: int, d: int) -> float:
    x = seed & M64
    for k, g in zip((a, b, c, d), (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                                   0x94D049BB133111EB, 0xD6E8FEB86659FD93)):
        x = (x + g * (k + 1)) & M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & M64
    x ^= x >> 31
    return (x >> 11) * (2.0 ** -53)


def victim_draw(seed: int) -> float:
    """The one uniform that places the scripted failure (salt 7)."""
    return hash_uniform(seed, 0, 0, 0, 7)


# ------------------------------------------------------------ threefry

def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def seed_key(seed: int) -> tuple[int, int]:
    return 0, seed & M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32(key[0], key[1], 0, data & M32)


def uniform(key: tuple[int, int], rows: int, cols: int,
            device) -> torch.Tensor:
    """float32 [rows, cols] in [0, 1): each element hashes its row-major
    index, split into (hi, lo) words; the two output words are xored and
    their top 23 bits become the mantissa of a float in [1, 2)."""
    idx = torch.arange(rows * cols, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32).view(rows, cols) - 1.0


# --------------------------------------------------------------- mix32

_GOLD = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1)


def _mul32(x, c: int):
    """``x * c mod 2^32`` without an int64 overflow (16-bit halves)."""
    if isinstance(x, int):
        return (x * c) & M32
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(seed, *keys):
    """uint32 hash of ``seed`` and up to five keys (ints or int64
    tensors of uint32 values, broadcasting)."""
    x = seed & M32
    for k, g in zip(keys, _GOLD):
        x = (x + _mul32(k + 1, g)) & M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def threshold32(prob: float) -> int:
    return min(M32, max(0, int(round(prob * 4294967296.0))))
