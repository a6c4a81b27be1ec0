"""Threefry-2x32 draws, bit-identical to ``jax.random`` (partitionable mode).

The dense model's message drops (ops/drop.py) are
``jax.random.uniform(jax.random.fold_in(PRNGKey(seed), t), (n + 2, n))``
in the JAX package.  The port reproduces those bits exactly, so a run of
either package from one seed drops the same messages.  What is
reproduced (jax 0.9.0, ``jax_threefry_partitionable=True``, its
default):

* ``PRNGKey(seed)`` is the pair ``[0, seed mod 2^32]``: with 64-bit
  types off (jax's default, which the JAX package keeps) the seed is
  taken as 32 bits, so the high word is 0;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``, i.e. the hash of
  the counter pair that ``threefry_seed(uint32(d))`` builds;
* ``random_bits(key, shape)`` hashes each element's row-major flat
  index, split into (hi, lo) 32-bit words, and returns
  ``bits1 ^ bits2``;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in
  [1, 2): ``((bits >> 9) | 0x3F800000)`` reinterpreted, minus 1.0.

torch has no logical right shift on uint32 on the CPU and its int32
``>>`` is arithmetic, so every word is held in int64 and masked to 32
bits after each add or shift.  The same code runs on CPU and CUDA
tensors, and on plain Python ints (for the one-element ``fold_in``).
The non-partitionable mode (``jax_threefry_partitionable=False``) is
not implemented.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds (``jax._src.prng`` lowering).

    ``k0``/``k1`` are the key words as Python ints; ``x0``/``x1`` the
    counter words, Python ints or int64 tensors holding values in
    [0, 2^32).  Returns the two output words in the same form.
    """
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a uint32[2] numpy pair (64-bit
    types off: the seed wraps to 32 bits and the high word is 0)."""
    return np.array([0, int(seed) & _M32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a non-negative int ``data``."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32))
    return np.array(threefry2x32(k0, k1, 0, int(data) & _M32), np.uint32)


def random_bits(key, shape, device) -> torch.Tensor:
    """uint32 random bits of ``shape`` as an int64 tensor on ``device``."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32))
    size = 1
    for d in shape:
        size *= int(d)
    idx = torch.arange(size, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    bits = random_bits(key, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0
