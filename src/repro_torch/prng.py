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
  ln(2³²-1))`` rounds of a stable sort keyed by fresh 32-bit draws;
* ``uniform`` and ``bernoulli`` (float32, ``mode='low'``): the draw is
  ``((bits >> 9) | 0x3F800000)`` viewed as float32, minus 1, and a
  Bernoulli(p) sample is ``draw < p`` with ``p`` a float32.

Keys are ``uint32[2]`` numpy arrays.  The lane-block masks draw a handful
of integers here on the host.  The element masks of the dense wire draw
one hash per activation, millions per exchange: :func:`random_bits_torch`
is the same stream in int64 tensor arithmetic on any device, the plain
version of the ``random_mask`` kernel (``repro_torch/kernels/
randmask.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def uniform(k: np.ndarray, shape) -> np.ndarray:
    """float32 ``jax.random.uniform(key, shape)`` on ``[0, 1)``."""
    bits = random_bits(k, shape)
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)) \
        .view(np.float32) - np.float32(1.0)


def bernoulli(k: np.ndarray, p, shape) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for a float32 ``p`` (mode
    ``'low'``): boolean ``uniform < p``."""
    return uniform(k, shape) < np.float32(p)


_M32 = 0xFFFFFFFF


def threefry2x32_torch(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` in int64 tensor arithmetic masked to 32 bits:
    ``x1``/``x2`` are int64 tensors of uint32 values; ``k1``/``k2`` ints or
    int64 tensors broadcastable against them."""
    k3 = k1 ^ k2 ^ int(_PARITY)
    ks = (k1, k2, k3)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def random_bits_torch(k, shape, device="cpu", offset: int = 0
                      ) -> torch.Tensor:
    """32-bit :func:`random_bits` as an int64 tensor on ``device``: the
    counter of element ``i`` of ``shape`` (row-major) is the 64-bit
    ``i + offset``, split into its ``(hi, lo)`` words.  ``k`` is one key
    (``uint32[2]``) or ``[Q, 2]`` keys, which prepend a worker dimension
    (``vmap`` over keys: every worker counts from 0)."""
    keys = torch.as_tensor(np.asarray(k, np.uint32).astype(np.int64),
                           device=device)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device) + int(offset)
    if keys.dim() == 2:
        k1, k2 = keys[:, :1], keys[:, 1:]
        out_shape = (keys.shape[0], *shape)
    else:
        k1, k2 = keys[0], keys[1]
        out_shape = tuple(shape)
    a, b = threefry2x32_torch(k1, k2, idx >> 32, idx & _M32)
    return (a ^ b).reshape(out_shape)
