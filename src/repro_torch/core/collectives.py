"""Compressed gradient collectives over Q emulated workers.

Counterpart of the gradient half of ``repro/core/collectives.py``: each
worker compresses its local contribution with a Definition-1 compressor
under its own key stream (``fold_in(key, worker)``, shared a priori, so
no index travels), the compressed contributions are summed (all-reduce)
or exchanged (all-to-all), and the bits charged are the ring's traffic
of the compressed payload.

The Q workers run one after another on one device, so a collective takes
every worker's contribution:

* :func:`compressed_psum` / :func:`compressed_pmean` — an iterable of the
  Q workers' trees, consumed one at a time: each tree is compressed leaf
  by leaf in place and added into a running sum before the next worker's
  tree is asked for, so a caller that computes each worker's gradients on
  demand (a generator) holds the sum, one worker's tree and one leaf,
  never Q trees;
* :func:`compressed_all_to_all` — one ``[Q, ...]`` stack, worker ``w``'s
  local array at ``x[w]``, compressed in one batched launch;
* :func:`uncompressed_bits` — the full-communication baseline's bits.

Every sum runs in worker order, and the bits in float32 in the JAX
package's order (leaf order within a worker, then over workers, then the
ring factor).  The all-gather and neighbour-exchange halves of the JAX
module ship activations between workers of a real mesh; they wait for the
multi-GPU backend.
"""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.compression import Compressor, _nbits
from repro_torch.train.optim import tree_leaves, tree_map

_F32 = torch.float32


def _per_device_key(key, worker: int) -> np.ndarray:
    """Worker ``worker``'s stream, derived from a key shared a priori
    (``fold_in(key, axis_index)``)."""
    return prng.fold_in(np.asarray(key, np.uint32), worker)


def _unflatten(skeleton, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), skeleton)


def _compress_leaves(leaves: list, worker: int, *, compressor: Compressor,
                    rate, key) -> torch.Tensor:
    """Worker ``worker``'s local half of :func:`compressed_psum`: every
    leaf of ``leaves`` (in ``tree_leaves`` order) is replaced in the list
    by its compressed round trip under its own key, ``split(fold_in(key,
    worker), n_leaves)[i]``; each original leaf is released before the
    next is compressed.  Returns the worker's payload bits, a float32
    sum in leaf order."""
    keys = prng.split(_per_device_key(key, worker), max(len(leaves), 1))
    bits = None
    for i, k in enumerate(keys[:len(leaves)]):
        leaves[i], b = compressor(k, leaves[i], rate)
        bits = b if bits is None else bits + b
    return torch.zeros((), dtype=_F32) if bits is None else bits


def _ring_bits(per_worker: list, factor: float) -> torch.Tensor:
    total = per_worker[0]
    for b in per_worker[1:]:
        total = total + b
    return total * float(np.float32(factor))


@torch.no_grad()
def compressed_psum(xs: Iterable, q: int, *, compressor: Compressor, rate,
                    key):
    """Compressed all-reduce (gradient aggregation over the data axis).

    ``xs`` yields the Q workers' trees in worker order (a list, or a
    generator that computes each on demand).  Returns ``(summed tree,
    wire_bits)``: the sum of the compressed contributions, and the
    payload bits summed over workers × the ring all-reduce's ``2(Q-1)/Q``
    (float32; 0 at Q = 1).  The trees' leaves are consumed: the caller
    keeps no reference to them."""
    acc = skeleton = None
    per_worker: list = []
    # no enumerate: its cached result tuple would keep the worker's tree
    # alive while its leaves are compressed
    for tree in xs:
        w = len(per_worker)
        leaves = tree_leaves(tree)
        if skeleton is None:
            skeleton = tree_map(lambda _: 0, tree)
        del tree
        per_worker.append(_compress_leaves(leaves, w, compressor=compressor,
                                           rate=rate, key=key))
        if acc is None:
            acc = leaves
        else:
            for i in range(len(leaves)):
                acc[i].add_(leaves[i])
                leaves[i] = None
    n = len(per_worker)
    if n != q:
        raise ValueError(f"compressed_psum: {n} worker trees for q={q}")
    return _unflatten(skeleton, acc), _ring_bits(per_worker,
                                                 2.0 * (q - 1) / q)


def compressed_pmean(xs: Iterable, q: int, *, compressor: Compressor, rate,
                     key):
    """FedAvg-style averaging (Algorithm 1's 'Server' step):
    :func:`compressed_psum` divided by Q (each leaf in place, in its
    dtype)."""
    summed, wire_bits = compressed_psum(xs, q, compressor=compressor,
                                        rate=rate, key=key)
    for leaf in tree_leaves(summed):
        leaf.div_(q)
    return summed, wire_bits


@torch.no_grad()
def compressed_all_to_all(x: torch.Tensor, *, compressor: Compressor, rate,
                          key, split_axis: int = 0, concat_axis: int = 0):
    """Compressed all-to-all (per-peer buffers): ``x [Q, ...]`` holds each
    worker's local array, whose ``split_axis`` has size Q (slice ``i`` is
    the buffer for peer ``i``).  Each worker compresses its whole array
    under its own key; worker ``w`` receives slice ``w`` of every sender's
    compressed array, stacked along ``concat_axis`` in sender order (the
    JAX package's untiled ``all_to_all``).  Returns ``(out [Q, ...],
    wire_bits)``, the bits summed over workers × ``(Q-1)/Q``: the slice a
    worker keeps for itself is not charged."""
    q = x.shape[0]
    if x.shape[1 + split_axis] != q:
        raise ValueError(f"compressed_all_to_all: split axis {split_axis} "
                         f"has size {x.shape[1 + split_axis]}, not Q = {q}")
    keys = np.stack([_per_device_key(key, w) for w in range(q)])
    x_tilde, bits = compressor.batched(keys, x, rate)
    # [sender, ..., receiver, ...] -> [receiver, sender, rest], then the
    # sender axis to concat_axis of the receiver's local array
    y = x_tilde.movedim(1 + split_axis, 1).transpose(0, 1)
    out = y.movedim(1, 1 + concat_axis).contiguous()
    total = bits[0]
    for b in bits[1:]:
        total = total + b
    return out, (total * float(q - 1)) / float(q)


def uncompressed_bits(x) -> torch.Tensor:
    """Bits of a tree at its native dtypes (the full-communication
    baseline), float32: the count is summed exactly, then rounded."""
    total = sum(leaf.numel() * _nbits(leaf.dtype) for leaf in tree_leaves(x))
    return torch.tensor(float(np.float32(total)), dtype=_F32)
