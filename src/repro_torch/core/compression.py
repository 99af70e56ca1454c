"""Compression / decompression mechanisms (paper Definition 1).

Counterpart of ``repro/core/compression.py``.  A compressor maps a tensor
``x`` and a ratio ``r >= 1`` to ``(x_tilde, wire_bits)``: ``x_tilde`` is
the compress -> decompress round trip the receiving worker sees, and
``wire_bits`` the traffic charged for it.

* ``randmask`` — the paper's mechanism: keep each element independently
  with probability ``1/r``, drawn from a key shared a priori, so only the
  kept payload is charged.  The mask is the ``random_mask`` CUDA kernel on
  the card (``repro_torch/kernels/randmask.py``), bitwise
  ``jax.random.bernoulli``;
* ``randmask_unbiased`` — the same mask rescaled by ``r`` (``E[x~] = x``);
* ``blockmask`` — keep ``K = max(floor((F/128)/r), 1)`` whole 128-lane
  blocks chosen by ``prng.permutation``: bitwise the kept set of the
  packed and p2p wires for the same key;
* ``topk`` — the ``k = max(int(size/r), 1)`` largest magnitudes (static
  rate only), ties broken toward the lower index as ``jax.lax.top_k``
  does;
* ``int8`` — per-row symmetric int8 quantisation, then the random mask at
  the residual rate ``max(r/4, 1)``.

Keys are ``uint32[2]`` numpy arrays (``repro_torch.prng``).  Every
compressor computes with a worker dimension in front — ``Compressor.
batched(keys [Q, 2], x [Q, ...], rate)`` is the JAX package's ``vmap`` of
the compressor over workers, one kernel launch for all of them — and
``compressor(key, x, rate)`` is the single-key call.  Rates are rounded
to float32 before any arithmetic, as ``jnp`` does on a float32 rate
(``p = 1/r`` in float64 would flip masks at the edges).

Gradients are the JAX package's, not straight-through: the mask
compressors pass the cotangent through the kept elements (times the
scale); ``int8``'s integer cast has no gradient, so the cotangent reaches
``x`` only through each row's ``amax`` scale (split evenly among ties in
both frameworks).  :func:`straight_through` wraps a compressor in the
identity backward.  :class:`Compressed` is the JAX package's wire
representation of one message, with its bit count.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.ops import random_mask
from repro_torch.kernels.randmask import keys_tensor
from repro_torch.spans import span

LANE = 128
_F32 = torch.float32


def _nbits(dtype: torch.dtype) -> int:
    if dtype.is_floating_point:
        return torch.finfo(dtype).bits
    return torch.iinfo(dtype).bits


def _f32(v) -> np.float32:
    """A rate as float32 (a float32 tensor's value is kept exactly)."""
    return np.float32(float(v))


def _rate32(rate) -> np.float32:
    """``jnp.maximum(jnp.asarray(rate, float32), 1.0)``."""
    return max(_f32(rate), np.float32(1.0))


def _keys(keys) -> np.ndarray:
    return np.asarray(keys, np.uint32).reshape(-1, 2)


@dataclasses.dataclass
class Compressed:
    """Wire representation of a compressed tensor.

    ``payload`` is what crosses the network.  ``meta`` holds side-band
    tensors (top-k indices, quantisation scales) that cross it too and
    are charged.  ``aux`` holds decoder state both ends derive from the
    shared key (masks), charged nothing.
    """

    payload: torch.Tensor
    meta: dict
    aux: dict

    def wire_bits(self) -> torch.Tensor:
        """Bits that cross the network for this message (payload and
        meta), an f32 scalar summed in f32 as the JAX package sums it."""
        bits = torch.zeros((), dtype=_F32)
        for t in (self.payload, *self.meta.values()):
            t = torch.as_tensor(t)
            bits = bits + torch.tensor(float(t.numel() * _nbits(t.dtype)),
                                       dtype=_F32)
        return bits


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Definition-1 compression mechanism.

    ``fn(keys [Q, 2], x [Q, ...], rate) -> (x_tilde [Q, ...], bits f32
    [Q])`` compresses each worker's block under its own key;
    ``eps2(rate)`` is the expected squared relative error
    ``E||x~ - x||² / ||x||²``."""

    name: str
    fn: Callable
    eps2: Callable

    def __call__(self, key, x: torch.Tensor, rate):
        """``(x_tilde, wire_bits)`` of one tensor under one key."""
        out, bits = self.fn(_keys(key)[:1], x[None], rate)
        return out[0], bits[0]

    def batched(self, keys, x: torch.Tensor, rate):
        """Every worker's block ``x[q]`` under its own key ``keys[q]``."""
        keys = _keys(keys)
        if keys.shape[0] != x.shape[0]:
            raise ValueError(f"{self.name}: {keys.shape[0]} keys for "
                             f"{x.shape[0]} blocks")
        return self.fn(keys, x, rate)


# -- paper mechanism: shared-PRNG random element subset ---------------------


def _random_mask(keys, x: torch.Tensor, rate, unbiased: bool):
    """Keep each element independently w.p. ``1/rate`` (paper Appendix);
    ``rate == 1`` keeps everything.  Only kept elements are charged."""
    rate = _rate32(rate)
    p = np.float32(1.0) / rate
    scale = rate if unbiased else np.float32(1.0)
    with span("sync.keys"):                 # a pageable copy
        keys = keys_tensor(keys, x.device)
    out, counts = random_mask(x, keys, float(p), float(scale))
    return out, (counts * _nbits(x.dtype)).to(_F32)


def random_mask_compressor(unbiased: bool = False) -> Compressor:
    name = "randmask_unbiased" if unbiased else "randmask"
    if unbiased:
        def eps2(r):
            return torch.clamp(torch.as_tensor(r, dtype=_F32) - 1.0, min=0.0)
    else:
        def eps2(r):
            return 1.0 - 1.0 / torch.clamp(torch.as_tensor(r, dtype=_F32),
                                           min=1.0)
    return Compressor(name, partial(_random_mask, unbiased=unbiased), eps2)


# -- lane-block mask (the packed-wire mechanism, dense round-trip form) ------


def _block_mask(keys, x: torch.Tensor, rate):
    """Keep ``K = max(floor((F/128)/rate), 1)`` whole 128-lane blocks of
    each worker's block: block ``b`` is kept iff its slot in
    ``prng.permutation(key, F/128)`` is below ``K``, the packed wire's
    kept set for the same key."""
    f = x.shape[-1]
    if f % LANE:
        raise ValueError(
            f"blockmask needs a feature width divisible by {LANE}, got {f}; "
            "use 'randmask' for off-lane-grid payloads")
    nb = f // LANE
    rate = _rate32(rate)
    k = max(np.floor(np.float32(nb) / rate), np.float32(1.0))
    pos = np.zeros((len(keys), nb), np.int32)
    for j, key in enumerate(keys):
        pos[j, prng.permutation(key, nb)] = np.arange(nb, dtype=np.int32)
    keep = torch.from_numpy(pos < k).to(x.device)            # [Q, nb]
    xb = x.reshape(*x.shape[:-1], nb, LANE)
    keep = keep.reshape(x.shape[0], *([1] * (x.dim() - 2)), nb, 1)
    out = torch.where(keep, xb, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    rows = x[0].numel() // f
    bits = k * np.float32(LANE) * np.float32(rows) * \
        np.float32(_nbits(x.dtype))
    return out.reshape(x.shape), torch.full((x.shape[0],), float(bits),
                                            dtype=_F32, device=x.device)


def block_mask_compressor() -> Compressor:
    return Compressor("blockmask", _block_mask, lambda r: 1.0 - 1.0 /
                      torch.clamp(torch.as_tensor(r, dtype=_F32), min=1.0))


# -- magnitude top-k ---------------------------------------------------------


def _topk_keep(a: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the ``k`` largest entries of flat ``a``, ties at the
    k-th value broken toward the lower index (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none)."""
    kth = torch.topk(a, k, sorted=False).values.min()
    above = a > kth
    tied = a == kth
    return above | (tied & (torch.cumsum(tied, 0) <= k - above.sum()))


def _topk(keys, x: torch.Tensor, rate):
    """Keep each worker's ``k = max(int(size/rate), 1)`` largest-magnitude
    elements; the int32 index of each kept element is charged too.
    ``rate`` is static (``float(rate)``), as in the JAX package."""
    del keys
    q = x.shape[0]
    flat = x.reshape(q, -1)
    r = float(rate)
    k = max(int(flat.shape[1] / max(r, 1.0)), 1)
    keep = torch.stack([_topk_keep(flat[j].detach().abs(), k)
                        for j in range(q)])
    out = torch.where(keep, flat, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    bits = float(np.float32(k * (_nbits(x.dtype) + 32)))
    return out.reshape(x.shape), torch.full((q,), bits, dtype=_F32,
                                            device=x.device)


def topk_compressor() -> Compressor:
    return Compressor("topk", _topk, lambda r: 1.0 - 1.0 / torch.clamp(
        torch.as_tensor(r, dtype=_F32), min=1.0))


# -- int8 affine quantisation ------------------------------------------------


def _int8(keys, x: torch.Tensor, rate):
    """Per-row symmetric int8 quantisation (effective rate 4 against f32),
    then the random mask at the residual rate ``max(rate/4, 1)``.  Wire:
    the surviving int8 elements plus every row's f32 scale."""
    q = x.shape[0]
    rows = x.reshape(q, -1, x.shape[-1]) if x.dim() > 2 else \
        x.reshape(q, 1, -1)
    amax = rows.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones((), dtype=x.dtype,
                                                           device=x.device))
    levels = torch.clamp(torch.round(rows / scale), -127, 127) \
        .to(torch.int8)                       # no gradient through levels
    deq = (levels.to(x.dtype) * scale).reshape(x.shape)
    quant_gain = np.float32(_nbits(x.dtype) / 8.0)
    residual = max(_f32(rate) / quant_gain, np.float32(1.0))
    masked, mask_bits = _random_mask(keys, deq, residual, unbiased=False)
    kept = mask_bits / float(_nbits(deq.dtype))
    bits = kept * 8.0 + float(np.float32(scale[0].numel() * 32))
    return masked, bits


def int8_compressor() -> Compressor:
    return Compressor("int8", _int8, lambda r: 1e-4 + (1.0 - 4.0 / torch.clamp(
        torch.as_tensor(r, dtype=_F32), min=4.0)))


# -- straight-through wrapper ------------------------------------------------


def straight_through(compress_fn):
    """Forward = compressed value, backward = identity: ``x + (x_tilde -
    x).detach()``, rounded as the JAX package's ``stop_gradient`` form."""

    def wrapped(key, x, rate):
        x_tilde, bits = compress_fn(key, x, rate)
        return x + (x_tilde - x).detach(), bits

    return wrapped


_REGISTRY: dict[str, Callable[[], Compressor]] = {
    "randmask": random_mask_compressor,
    "randmask_unbiased": partial(random_mask_compressor, unbiased=True),
    "blockmask": block_mask_compressor,
    "topk": topk_compressor,
    "int8": int8_compressor,
}


def get_compressor(name: str) -> Compressor:
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def available_compressors() -> list[str]:
    return sorted(_REGISTRY)
