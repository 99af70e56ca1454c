"""Bitwise numpy port of the slice of ``jax.random`` the wire masks draw.

The p2p wire's kept lane-blocks come from a key stream shared by sender
and receiver: ``fold_in(fold_in(key(seed), call), worker)`` followed by
``permutation`` (``repro/kernels/varco_pack.py:276-330``).  To carry the
JAX package's masks over exactly, this module reimplements, in numpy
``uint32`` arithmetic:

* the Threefry-2x32 hash (20 rounds, key schedule with ``0x1BD11BDA``);
* ``key(seed)`` — the raw ``[hi, lo]`` 32-bit halves of the seed;
* ``fold_in``, ``split`` and ``random_bits`` in the
  ``jax_threefry_partitionable=True`` layout (jax's default since 0.5):
  the counters are the ``(hi, lo)`` words of a uint64 iota over the
  output shape, and 32-bit draws are ``bits1 ^ bits2``;
* ``permutation`` of ``arange(n)`` — jax's ``_shuffle``: ``ceil(3 ln n /
  ln(2³²-1))`` rounds of a stable sort keyed by fresh 32-bit draws.

Keys are ``uint32[2]`` numpy arrays.  At the slice's widths (1 or 2
lane-blocks) this is host work on a handful of integers.
"""

from __future__ import annotations

import math

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher on counter pairs ``(x1, x2)``
    (broadcast uint32 arrays) under key ``(k1, k2)``."""
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s raw data for a 32-bit seed: ``[0,
    seed mod 2^32]`` (the high word of a 32-bit seed is 0)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    """``(hi, lo)`` uint32 words of ``arange(prod(shape), dtype=uint64)``
    reshaped to ``shape``."""
    c = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (c >> np.uint64(32)).astype(np.uint32), \
        (c & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``."""
    y1, y2 = threefry2x32(k[0], k[1], np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y1[0], y2[0]], np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable layout): ``uint32[num, 2]``."""
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32-bit ``jax.random.bits`` (partitionable layout)."""
    shape = tuple(shape)
    hi, lo = _iota_2x32(shape)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return b1 ^ b2


def permutation(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: int32 shuffle of ``arange(n)``."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) /
                         np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        sort_keys = random_bits(sub, (n,))
        x = x[np.argsort(sort_keys, kind="stable")]
    return x
