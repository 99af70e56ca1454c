"""Compressed collectives: the gradient half over Q emulated workers, the
activation half over a group of Q processes.

Counterpart of ``repro/core/collectives.py``.  The gradient half: each
worker compresses its local contribution with a Definition-1 compressor
under its own key stream (``fold_in(key, worker)``, shared a priori, so
no index travels), the compressed contributions are summed (all-reduce)
or exchanged (all-to-all), and the bits charged are the ring's traffic
of the compressed payload.

* :func:`compressed_psum` / :func:`compressed_pmean` / :func:`psum` —
  over a mesh of the ``"data"`` axis: a :class:`DPMesh` (its Q workers
  emulated one after another on one device; a bare worker count means
  one) or a :class:`WorkerMesh` (one process per worker).  ``xs`` yields
  the trees of the mesh's local workers (``mesh.workers``: all Q of an
  emulated mesh, this process's one of a group), consumed one at a time:
  each tree is compressed leaf by leaf in place under its worker's stream
  and added into a running sum before the next tree is asked for, so a
  caller that computes each worker's gradients on demand (a generator)
  holds the sum, one worker's tree and one leaf, never Q trees.  The mesh
  then sums across its processes (``mesh.reduce_leaves``: nothing to do
  on an emulated mesh) and gathers the per-worker bits (``mesh.gather``);
* :func:`compressed_all_to_all` — one ``[Q, ...]`` stack, worker ``w``'s
  local array at ``x[w]``, compressed in one batched launch;
* :func:`uncompressed_bits` — the full-communication baseline's bits.

Every sum runs in worker order, and the bits in float32 in the JAX
package's order (leaf order within a worker, then over workers, then the
ring factor).

Over a group each leaf is summed in rank order, as the emulated workers
are added, at a ring all-reduce's traffic (:func:`_rank_order_sum`: a
reduce-scatter by ``Q - 1`` hops, then an all-gather back into the
leaf's own storage): a backend's all-reduce adds in its own order, which
in bf16 rounds otherwise (three AdamW steps of granite's smoke config in
bf16 drifted 3.8e-2 of a leaf's norm from the emulated run), so the
group's sums are the emulated sums bitwise.  The leaves go one at a time
in ``tree_leaves`` order, so the peak is the tree and, beside the leaf
being reduced, ``(Q-1)/Q`` of it received and a ``1/Q`` accumulator:
one leaf's worth (and a padded copy of a leaf whose size Q does not
divide).  The per-worker payload bits are all-gathered and summed in
rank order too (f32 sums near 1e10 change with summation order), so the
group's bits equal the emulated ones exactly.  What moves is not what is
charged: ``randmask`` zeroes entries but the group ships the dense leaf,
every byte of it (``WorkerMesh.sent_bytes``), while the bits charge the
compressed payload; that is the JAX package's accounting too (its
``psum`` of the masked tree).

The activation half ships halo activations between the processes of a
:class:`WorkerMesh` (one process per worker over ``torch.distributed``;
the JAX package's ``shard_map`` axis), each call made by every worker of
the group with its own local block:

* :func:`compressed_all_gather` — the dense wire: compress, all-gather;
* :func:`packed_all_gather` — the packed wire: ``wire_pack`` the kept
  lane-blocks, all-gather the ``[B, K·128]`` payload, ``wire_unpack``
  every sender's block;
* :func:`neighbor_exchange_start` / :func:`neighbor_exchange_finish`
  (and :func:`neighbor_exchange`, both at once) — the p2p ring: the
  ``Q - 1`` hops go out in one ``batch_isend_irecv`` at ``start`` and are
  waited on at ``finish``, so the caller's local work overlaps them.

Gradients cross the group as in JAX: an all-gather's cotangent is
all-reduced and each worker keeps its own slice (``psum(g)[axis_index]``,
:func:`_all_gather_grad_carrier`), a hop's cotangent rides the inverse
ring (:func:`_ppermute_grad_carrier`).  Both carriers are zero-valued
forwards added to the detached received values, so autograd routes each
cotangent back into the sender's compressor or pack.

The packed all-gather and the ring also carry the closed loop's channels,
as the JAX package's do: a per-pair ``[Q, Q]`` rate map (``pair_k``,
each pair's kept-block count carved out of the sender's kept set by
column masks), a width map (``pair_w``, the straight-through
``wire_quant`` on the fp32 value path, rounded half to even or
stochastically under the per-pair ``round_key`` stream), error-feedback
residuals on the ring (``resid`` / ``resid_out``) and true sub-byte
storage (``store_w``): the sender's fused ``pack_quant`` produces a
uint8 payload and f32 block scales, those two buffers cross the group,
and the receiver's ``unpack_quant`` rebuilds the rows; their cotangents
return in f32 at the kept blocks' width (:class:`_DecodedGrad`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time
from collections.abc import Iterable
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core.compression import Compressor, _nbits
from repro_torch.kernels.ops import (pack_quant, per_block_wire_bits,
                                     qmax_of, round_key, unpack_quant,
                                     wire_pack, wire_quant, wire_unpack)
from repro_torch.kernels.varco_pack import (LANE, worker_block_maps,
                                            worker_block_maps_pos)
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


def _rank_order_sum(t: torch.Tensor, mesh: "WorkerMesh") -> torch.Tensor:
    """Every worker's ``t`` summed in rank order, ``((t_0 + t_1) + t_2) +
    …`` in ``t``'s dtype, as the emulated workers are added, at a ring
    all-reduce's traffic (``2(Q-1)/Q`` of ``t`` a worker): worker ``r``
    receives chunk ``r`` of every peer's ``t`` in one batch of ``Q - 1``
    hops, adds the ``Q`` chunks in rank order, and the reduced chunks are
    all-gathered back into ``t``'s storage (``t`` is consumed).  Beside
    ``t`` the worker holds ``(Q-1)/Q`` of it received and a ``1/Q``
    accumulator, and a padded copy of ``t`` where Q does not divide its
    size."""
    q, r = mesh.q, mesh.rank
    if q == 1:
        return t
    flat = t.reshape(-1)
    n = flat.numel()
    c = -(-n // q)
    if c * q != n:
        flat = torch.cat([flat, flat.new_zeros(c * q - n)])
    chunks = flat.view(q, c)
    offsets = tuple(range(1, q))
    got = mesh.ring_wait(mesh.ring_start(
        chunks[[(r + d) % q for d in offsets]], offsets))
    acc = None
    for w in range(q):                     # slot d - 1 came from rank r - d
        part = chunks[r] if w == r else got[(r - w) % q - 1]
        acc = part.clone() if acc is None else acc.add_(part)
    del got, part
    mesh.all_gather(acc, out=chunks)
    return flat[:n].view(t.shape)


@dataclasses.dataclass(frozen=True)
class DPMesh:
    """``size`` data-parallel workers emulated on ``device``, one after
    another: the counterpart of the JAX package's 1-D ``"data"`` mesh.

    It shares its surface with :class:`WorkerMesh`: ``q``, the local
    ``workers`` (here all of them), ``reduce_leaves`` (the sum across
    processes: here there is none) and ``gather`` (every worker's value:
    here they are all local)."""

    size: int
    device: torch.device | None = None

    @property
    def q(self) -> int:
        return self.size

    @property
    def workers(self) -> range:
        return range(self.size)

    def reduce_leaves(self, leaves: list) -> None:
        """The local sum is every worker's: nothing crosses."""

    def gather(self, values: list) -> list:
        """Every worker's value, in worker order: ``values`` itself."""
        return list(values)


def _as_mesh(mesh) -> "DPMesh | WorkerMesh":
    """A worker count as the emulated mesh of that many workers."""
    return DPMesh(int(mesh)) if isinstance(mesh, (int, np.integer)) else mesh


def _local_sum(xs: Iterable, mesh, what: str, compress=None):
    """The trees of ``xs``, one per local worker of ``mesh`` in order,
    summed leaf by leaf into the first tree's leaves (in place), each
    tree's leaves first passed through ``compress(leaves, worker)``, which
    returns that worker's payload bits.  Returns ``(skeleton, leaves,
    bits per local worker)``."""
    workers = list(mesh.workers)
    acc = skeleton = None
    bits: list = []
    # no enumerate: its cached result tuple would keep the worker's tree
    # alive while its leaves are compressed
    for tree in xs:
        n = len(bits)
        if n == len(workers):
            raise ValueError(f"{what}: more than {n} worker trees for "
                             f"q={mesh.q}, {n} of them on this process")
        leaves = tree_leaves(tree)
        if skeleton is None:
            skeleton = tree_map(lambda _: 0, tree)
        del tree
        bits.append(None if compress is None else
                    compress(leaves, workers[n]))
        if acc is None:
            acc = leaves
        else:
            for i in range(len(leaves)):
                acc[i].add_(leaves[i])
                leaves[i] = None
    if len(bits) != len(workers):
        raise ValueError(f"{what}: {len(bits)} worker trees for q={mesh.q}, "
                         f"{len(workers)} of them on this process")
    return skeleton, acc, bits


@torch.no_grad()
def psum(xs: Iterable, mesh):
    """The plain sum of the workers' trees over ``mesh`` (a
    :class:`DPMesh`, a worker count or a :class:`WorkerMesh`; ``xs``
    yields its local workers' trees, whose leaves are consumed).  Returns
    the summed tree."""
    mesh = _as_mesh(mesh)
    skeleton, leaves, _ = _local_sum(xs, mesh, "psum")
    mesh.reduce_leaves(leaves)
    return _unflatten(skeleton, leaves)


@torch.no_grad()
def compressed_psum(xs: Iterable, mesh, *, compressor: Compressor, rate,
                    key):
    """Compressed all-reduce (gradient aggregation over the data axis).

    ``xs`` yields the trees of ``mesh``'s local workers in worker order (a
    list, or a generator that computes each on demand); ``mesh`` is a
    :class:`DPMesh`, a worker count (that many emulated workers) or a
    :class:`WorkerMesh`.  Returns ``(summed tree, wire_bits)``: the sum of
    the compressed contributions, and the payload bits summed over
    workers × the ring all-reduce's ``2(Q-1)/Q`` (float32; 0 at Q = 1).
    The trees' leaves are consumed: the caller keeps no reference to
    them."""
    mesh = _as_mesh(mesh)
    skeleton, leaves, bits = _local_sum(
        xs, mesh, "compressed_psum",
        lambda ls, w: _compress_leaves(ls, w, compressor=compressor,
                                       rate=rate, key=key))
    mesh.reduce_leaves(leaves)
    return _unflatten(skeleton, leaves), _ring_bits(
        mesh.gather(bits), 2.0 * (mesh.q - 1) / mesh.q)


def compressed_pmean(xs: Iterable, mesh, *, compressor: Compressor, rate,
                     key):
    """FedAvg-style averaging (Algorithm 1's 'Server' step):
    :func:`compressed_psum` divided by Q (each leaf in place, in its
    dtype)."""
    mesh = _as_mesh(mesh)
    summed, wire_bits = compressed_psum(xs, mesh, compressor=compressor,
                                        rate=rate, key=key)
    for leaf in tree_leaves(summed):
        leaf.div_(mesh.q)
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


# ---------------------------------------------------------------------------
# The activation half: one process per worker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerMesh:
    """This process's place in a process group of ``q`` worker processes:
    its ``rank``, its ``device`` and the group's ``torch.distributed``
    ``backend``, built by ``repro_torch.dist.gnn_parallel.
    make_worker_mesh`` over the default group.  ``group`` is a subgroup
    of the job instead (``None``: the default group) and ``ranks`` the
    job-wide ranks of its members in rank order (``None``: ``0..q-1``);
    ``gnn_parallel.shrink_mesh`` builds such a mesh for the workers that
    survive a crash, with the per-operation ``timeout`` of the job's group
    (``None``: ``torch.distributed``'s default).

    Its methods are the transport under the collectives.  Under ``gloo``
    with a CUDA device (``staged``) every send, receive and reduction goes
    through pinned host buffers, since gloo takes no CUDA pointers for
    point-to-point operations.  ``sent_bytes`` is computed from the
    payload sizes, not read off the wire: an all-gather counts its block
    to each of ``q - 1`` peers, an all-reduce ``2(q-1)/q`` of the buffer,
    a ring's share whatever algorithm the backend picks.  ``staged_bytes``
    counts what was copied between the card and the host for them, and
    ``comm_s`` the host seconds spent inside the transport (staging, the
    collectives, the waits on posted hops; not the time hops spend in
    flight while the caller computes)."""

    q: int
    rank: int
    device: torch.device
    backend: str
    sent_bytes: int = 0
    staged_bytes: int = 0
    comm_s: float = 0.0
    group: Any = None
    ranks: tuple | None = None
    timeout: datetime.timedelta | None = None

    def __post_init__(self):
        self.ranks = tuple(range(self.q)) if self.ranks is None else \
            tuple(int(r) for r in self.ranks)
        if len(self.ranks) != self.q:
            raise ValueError(f"a mesh of {self.q} workers needs {self.q} "
                             f"member ranks, got {self.ranks}")

    @contextlib.contextmanager
    def _timed(self):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.comm_s += time.perf_counter() - t

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport sends it: contiguous, and copied to
        pinned host memory when staged."""
        t = t.detach()
        if not self.staged:
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)                            # waits for the producer
        self.staged_bytes += h.numel() * h.element_size()
        return h

    def _empty(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _in(self, h: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return h
        self.staged_bytes += h.numel() * h.element_size()
        return h.to(self.device, non_blocking=True)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every worker's ``t`` (a new tensor)."""
        with self._timed():
            h = self._out(t)
            if not self.staged:
                h = h.clone()                 # reduced in place
            dist.all_reduce(h, group=self.group)
            self.sent_bytes += (2 * (self.q - 1) * h.numel() *
                                h.element_size()) // self.q
            return self._in(h)

    def all_gather(self, t: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
        """``[q, *t.shape]``: every worker's ``t`` in rank order, written
        into ``out`` (on this worker's device) when it is given."""
        with self._timed():
            h = self._out(t)
            direct = out is not None and not self.staged
            buf = out if direct else self._empty((self.q, *h.shape),
                                                 h.dtype)
            dist.all_gather(list(buf.unbind(0)), h, group=self.group)
            self.sent_bytes += (self.q - 1) * h.numel() * h.element_size()
            if out is None:
                return self._in(buf)
            if not direct:
                self.staged_bytes += buf.numel() * buf.element_size()
                out.copy_(buf, non_blocking=True)
            return out

    @property
    def workers(self) -> tuple:
        """The workers this process runs: its own."""
        return (self.rank,)

    def reduce_leaves(self, leaves: list) -> None:
        """Every worker's ``leaves`` summed over the group in rank order,
        one leaf at a time in list order (:func:`_rank_order_sum`); each
        slot is replaced by its sum."""
        for i in range(len(leaves)):
            leaves[i] = _rank_order_sum(leaves[i], self)

    def gather(self, values: list) -> list:
        """Every worker's value, in rank order: ``values`` holds this
        process's one tensor."""
        (t,) = values
        every = self.all_gather(t.reshape(-1))
        return list(every.view(self.q, *t.shape).unbind(0))

    def barrier(self) -> None:
        """Wait until every worker of the mesh reaches this call."""
        with self._timed():
            dist.barrier(group=self.group)

    def ring_start(self, bufs, offsets) -> "RingTransfer":
        """Post one batch of hops: ``bufs[i]`` goes to worker ``(rank +
        offsets[i]) mod q`` while slot ``i`` of the returned transfer
        receives worker ``(rank - offsets[i]) mod q``'s ``bufs[i]``.
        ``bufs`` is one ``[D, ...]`` tensor or a tuple of them (the
        sub-byte wire's payload and scales), each sent whole per hop."""
        many = isinstance(bufs, tuple)
        with self._timed():
            send = tuple(self._out(b) for b in (bufs if many else (bufs,)))
            recv = tuple(self._empty(b.shape, b.dtype) for b in send)
            ops = []
            for n, (s, r) in enumerate(zip(send, recv)):
                for i, d in enumerate(offsets):
                    tag = n * len(offsets) + i
                    ops.append(dist.P2POp(
                        dist.isend, s[i],
                        self.ranks[(self.rank + d) % self.q],
                        group=self.group, tag=tag))
                    ops.append(dist.P2POp(
                        dist.irecv, r[i],
                        self.ranks[(self.rank - d) % self.q],
                        group=self.group, tag=tag))
                self.sent_bytes += s.numel() * s.element_size()
            return RingTransfer(dist.batch_isend_irecv(ops),
                                send if many else send[0],
                                recv if many else recv[0])

    def ring_wait(self, transfer: "RingTransfer"):
        """The received hops of a posted batch, on this worker's device
        (a tuple when a tuple was posted)."""
        with self._timed():
            for work in transfer.works:
                work.wait()
            if isinstance(transfer.recv, tuple):
                return tuple(self._in(r) for r in transfer.recv)
            return self._in(transfer.recv)


@dataclasses.dataclass
class RingTransfer:
    """A posted batch of hops: the work handles, and the send and receive
    buffers they use (held until the batch is waited on)."""

    works: list
    send: torch.Tensor | tuple
    recv: torch.Tensor | tuple


class _PpermuteGradCarrier(torch.autograd.Function):
    """Zero forward; backward: each hop's cotangent rides the inverse
    ring back to its sender."""

    @staticmethod
    def forward(ctx, x, mesh, offsets):
        ctx.mesh, ctx.offsets = mesh, offsets
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        back = mesh.ring_start(g, tuple(-d for d in ctx.offsets))
        return mesh.ring_wait(back), None, None


def _ppermute_grad_carrier(x: torch.Tensor, mesh: WorkerMesh,
                           offsets) -> torch.Tensor:
    """Zero-valued forward of ``x``'s shape whose VJP is the inverse-ring
    hop: ``x [D, ...]`` stacks the hops this worker sent, hop ``i`` to
    worker ``rank + offsets[i]``.  The receiver's value is ``received.
    detach() + carrier(sent)``, so each hop's cotangent reaches the
    sender's rows (``ppermute``'s transpose)."""
    return _PpermuteGradCarrier.apply(x, mesh, tuple(offsets))


class _AllGatherGradCarrier(torch.autograd.Function):
    """Zero ``[Q, ...]`` forward; backward: the all-gather's transpose."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.new_zeros((mesh.q, *x.shape))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g)[ctx.mesh.rank], None


def _all_gather_grad_carrier(x: torch.Tensor,
                             mesh: WorkerMesh) -> torch.Tensor:
    """Zero-valued ``[Q, *x.shape]`` forward whose VJP all-reduces the
    ``[Q, ...]`` cotangent and keeps this worker's slice (JAX's
    ``psum(g)[axis_index]``)."""
    return _AllGatherGradCarrier.apply(x, mesh)


def _gather(x: torch.Tensor, mesh: WorkerMesh) -> torch.Tensor:
    """Differentiable all-gather: ``[Q, *x.shape]``."""
    out = mesh.all_gather(x)
    return out + _all_gather_grad_carrier(x, mesh) if x.requires_grad \
        else out


class _DecodedGrad(torch.autograd.Function):
    """The sub-byte wire's gradient path.  Forward: the rows a receiver
    rebuilt from uint8 payloads and f32 scales, as they are.  Backward:
    their cotangent packed to each sender's kept blocks (``varco_pack``),
    carried back to the senders by ``carry`` (the inverse ring, or the
    all-gather's all-reduce), and scattered onto this worker's
    pre-quantisation rows (``varco_unpack``): straight through on kept
    blocks and zero on dropped ones, as ``ops._QuantHop``, with the
    cotangent in f32 at the fp32 wire's ``K·128`` columns."""

    @staticmethod
    def forward(ctx, pre, decoded, carry, kept_src, inv_own):
        ctx.carry = carry
        ctx.save_for_backward(kept_src, inv_own)
        return decoded.view_as(decoded)

    @staticmethod
    def backward(ctx, g):
        kept_src, inv_own = ctx.saved_tensors
        back = ctx.carry(wire_pack(g, kept_src))
        return wire_unpack(back, inv_own), None, None, None, None


def _check_channels(pair_k, pair_w, store_w: int, rounding: str,
                    resid=None) -> None:
    """The closed loop's channels ride one another, as in the JAX
    package: widths the rate map, storage and residuals the widths."""
    if pair_w is not None and pair_k is None:
        raise ValueError("pair_w needs pair_k (widths ride the rate map)")
    if store_w and pair_w is None:
        raise ValueError("store_w (sub-byte storage) rides the width map; "
                         "pass pair_w alongside it")
    if resid is not None and pair_w is None:
        raise ValueError("error-feedback residuals ride the quantised "
                         "wire; pass pair_w alongside resid")
    if rounding not in ("rint", "stochastic"):
        raise ValueError(f"rounding must be 'rint' or 'stochastic', got "
                         f"{rounding!r}")


def sender_maxima(pair_k, pair_w=None):
    """``(k_send [Q], w_send [Q] | None)``: what each sender of the packed
    all-gather ships, whose one payload serves every receiver — the most
    demanding receiver's kept count (at least one block) and width (32
    where no receiver names one), the off-diagonal column maxima of the
    receiver × sender maps."""
    pair_k = np.asarray(pair_k)
    eye = np.eye(pair_k.shape[0], dtype=bool)
    k_send = np.maximum(np.where(eye, 0, pair_k).max(axis=0), 1)
    if pair_w is None:
        return k_send, None
    w_send = np.where(eye, np.float32(0.0), np.asarray(pair_w,
                                                        np.float32)).max(0)
    return k_send, np.where(w_send > 0.0, w_send,
                            np.float32(32.0)).astype(np.float32)


def _to(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def compressed_all_gather(x: torch.Tensor, mesh: WorkerMesh, *,
                          compressor: Compressor, rate, key,
                          group_bits: bool = True):
    """All-gather of compressed activations (the dense halo wire).

    Each worker compresses its local block ``x`` under ``fold_in(key,
    rank)``, then the blocks are gathered: ``[Q, *x.shape]`` in rank
    order.  Returns ``(gathered, wire_bits)``, the bits the sum of every
    worker's payload bits × ``(Q - 1)`` peers (float32, the same on every
    worker).  ``group_bits=False`` returns ``None`` for the bits and skips
    their all-reduce: a caller whose ledger is computed on the host saves
    a round trip of the group (under XLA the unused psum is dropped)."""
    x_tilde, bits = compressor(_per_device_key(key, mesh.rank), x, rate)
    gathered = _gather(x_tilde, mesh)
    if not group_bits:
        return gathered, None
    return gathered, mesh.all_reduce(bits.to(_F32).reshape(1))[0] * \
        float(mesh.q - 1)


def _kept_maps(key, q: int, f: int, n_keep: int, device):
    """Every worker's ``(kept [Q, K], inv [Q, F/128])`` on ``device``."""
    kept, inv = worker_block_maps(key, q, f // LANE, n_keep)
    return _to(kept, device), _to(inv, device)


def _own_maps(kept: torch.Tensor, inv: torch.Tensor, rank: int):
    """Worker ``rank``'s rows of the maps, each in its own allocation (the
    kernels take 16-byte aligned index vectors; a row of a ``[Q, K]``
    table starts at ``4·K·rank`` bytes)."""
    return kept[rank].clone(), inv[rank].clone()


def packed_all_gather(x: torch.Tensor, mesh: WorkerMesh, *, key,
                      rate: float | None = None, n_keep: int | None = None,
                      pair_k=None, pair_w=None, rounding: str = "rint",
                      store_w: int = 0, wire_out: list | None = None):
    """All-gather of packed boundary activations (the packed wire).

    Worker ``rank`` packs its ``[B, F]`` block to the kept lane-blocks of
    ``fold_in(key, rank)`` (``wire_pack``), the ``[B, K·128]`` payloads
    are gathered, and every sender's payload is unpacked with its inverse
    map re-derived from the shared ``key`` (``wire_unpack``, zero fill),
    so no index travels and the halo equals the dense ``blockmask`` round
    trip bitwise.  ``K = n_keep``, or ``max(floor((F/128)/rate), 1)``
    from a static ``rate``.

    ``pair_k`` (host ``[Q, Q]`` receiver × sender kept counts, ``n_keep``
    their static maximum) is a per-pair rate map at this wire's
    granularity, per sender: one payload serves every receiver, so sender
    ``j`` keeps its most demanding receiver's count (:func:`sender_maxima`)
    by zeroing the packed columns past it in its permutation.  ``pair_w``
    (host ``[Q, Q]`` widths) quantises each sender's surviving columns at
    its receivers' maximum width through the straight-through
    ``wire_quant`` (``rounding="stochastic"`` under ``round_key(key,
    rank)``), and ``store_w`` ships them as sub-byte storage instead: the
    fused ``pack_quant`` gives a uint8 payload ``[B, K·128·store_w/8]`` and
    f32 scales ``[B, K]``, both all-gathered, and ``unpack_quant`` rebuilds
    every sender's rows; gradients return through :class:`_DecodedGrad`.
    ``wire_out``, a list, receives the ``(payload, scales)`` this worker
    handed to the transport (``(fp32 payload, None)`` on the value path).

    Returns ``(gathered [Q, B, F], collective_bits)``: every worker's
    payload, padding rows included, crossing to ``Q - 1`` peers — at
    :func:`~repro_torch.kernels.ops.per_block_wire_bits` of each sender's
    width under ``pair_w`` (the same on every worker, computed from the
    shared maps without a collective)."""
    _check_channels(pair_k, pair_w, store_w, rounding)
    f = x.shape[-1]
    if f % LANE:
        raise ValueError(f"packed wire needs F % {LANE} == 0, got F={f}")
    if n_keep is None:
        if rate is None:
            raise ValueError("pass n_keep or a static rate")
        n_keep = max(int(f // LANE / max(float(rate), 1.0)), 1)
    q, me, dev = mesh.q, mesh.rank, x.device
    kept_np, inv_np, pos_np = worker_block_maps_pos(key, q, f // LANE,
                                                    n_keep)
    kept, inv = _to(kept_np, dev), _to(inv_np, dev)
    kept_me, inv_me = _own_maps(kept, inv, me)
    bits = float(x.shape[0] * n_keep * LANE * 32 * q * (q - 1))
    if pair_k is None:
        halo = wire_unpack(_gather(wire_pack(x, kept_me, inv_me), mesh),
                           inv, kept)
        return halo, torch.tensor(bits, dtype=_F32)
    k_send, w_send = sender_maxima(pair_k, pair_w)
    rk = round_key(key, me) if pair_w is not None and \
        rounding == "stochastic" else None
    if store_w:
        colmask = np.repeat(pos_np[me] < k_send[me], LANE)[None, :]
        pre = x * _to(colmask, dev, _F32)
        payload, scales = pack_quant(pre, kept_me, store_w,
                                     qmax=qmax_of(w_send[me:me + 1]),
                                     keys=rk)
        if wire_out is not None:
            wire_out.append((payload, scales))
        halo = unpack_quant(mesh.all_gather(payload),
                            mesh.all_gather(scales), inv, store_w)
        if pre.requires_grad:
            halo = _DecodedGrad.apply(
                pre, halo, lambda g: mesh.all_reduce(g)[me], kept, inv_me)
    else:
        cmask = np.repeat(pos_np[me][kept_np[me]] < k_send[me], LANE)
        packed = wire_pack(x, kept_me, inv_me) * _to(cmask[None, :], dev,
                                                     _F32)
        if pair_w is not None:
            packed = wire_quant(packed, w_send[me], key=rk)
        if wire_out is not None:
            wire_out.append((packed.detach(), None))
        halo = wire_unpack(_gather(packed, mesh), inv, kept)
    if pair_w is not None:
        per = x.shape[0] * n_keep * per_block_wire_bits(w_send)
        return halo, per.sum() * float(q - 1)
    return halo, torch.tensor(bits, dtype=_F32)


@dataclasses.dataclass
class PendingHops:
    """The issued half of a neighbour exchange: the hops this worker sent
    ``[D, H, ·]``, still in autograd's graph (the on-wire rows, or under
    ``store_w`` the full-width pre-quantisation rows), their transfer
    (None at ``Q = 1``), the unpacked feature width ``f`` and the
    sub-byte storage width (0: the hops are f32 rows)."""

    sent: torch.Tensor | None
    transfer: RingTransfer | None
    f: int
    store_w: int = 0


def neighbor_exchange_start(publish: torch.Tensor, send_slot: torch.Tensor,
                            send_valid: torch.Tensor, mesh: WorkerMesh, *,
                            key=None, n_keep: int | None = None,
                            pair_k=None, pair_w=None, resid=None,
                            resid_out: list | None = None,
                            rounding: str = "rint", store_w: int = 0,
                            wire_out: list | None = None,
                            group_bits: bool = True):
    """Issue half of :func:`neighbor_exchange`: pack the boundary block
    once and post all ``Q - 1`` ring hops in one batch, but do not wait.

    ``publish [B, F]`` is this worker's boundary block (invalid rows
    zeroed); ``send_slot``/``send_valid [Q-1, H]`` hold, per ring offset
    ``d``, the boundary slots worker ``(rank + d) mod Q`` references and
    their 0/1 padding mask.  With ``n_keep`` the block is packed to its
    kept lane-blocks under ``fold_in(key, rank)`` before the hop rows
    are sliced out of it.

    ``pair_k`` (host ``[Q, Q]`` receiver × sender kept counts, ``n_keep``
    their static maximum) masks hop ``d`` down to receiver ``(rank + d)
    mod Q``'s own count; the hop keeps its ``n_keep`` blocks' shape, as
    JAX's ``ppermute`` does.  ``pair_w`` (host ``[Q, Q]`` widths)
    quantises each hop at its pair's width through the straight-through
    ``wire_quant``; ``rounding="stochastic"`` draws hop ``d``'s uniforms
    under ``round_key(key, rank, d - 1)``, the emulated backend's stream
    for this (sender, hop).  ``store_w`` ships each hop as sub-byte
    storage: ``pack_quant`` at the pair's ``qmax`` gives a uint8 payload
    ``[D, H, K·128·store_w/8]`` and f32 scales ``[D, H, K]``, the two
    buffers ride the ring, and :func:`neighbor_exchange_finish` rebuilds
    the rows with ``unpack_quant``.  ``resid [D, H, F]`` is this worker's
    error-feedback slab: added (at the pair's live rows and columns)
    before quantising; the new error ``pre - dequant(sent)`` is appended
    to ``resid_out`` — under ``store_w`` through one more
    ``unpack_quant`` of this worker's own payload.  ``wire_out``, a list,
    receives the ``(payload, scales)`` handed to the transport (``(rows,
    None)`` for f32 hops).

    Returns ``(pending, wire_bits)``: the :class:`PendingHops` that
    :func:`neighbor_exchange_finish` consumes, and the genuine rows
    shipped group-wide × on-wire columns × 32 (each pair's kept blocks at
    :func:`~repro_torch.kernels.ops.per_block_wire_bits` of its width
    under ``pair_w``; ``None``, without the all-reduce, under
    ``group_bits=False``; see :func:`compressed_all_gather`)."""
    if pair_k is not None and n_keep is None:
        raise ValueError("pair_k needs n_keep (the map's static maximum)")
    _check_channels(pair_k, pair_w, store_w, rounding, resid)
    q, f, me = mesh.q, publish.shape[-1], mesh.rank
    width = f if n_keep is None else n_keep * LANE
    if q == 1:
        if resid is not None and resid_out is not None:
            resid_out.append(resid)        # no wire at Q = 1: state carries
        return PendingHops(None, None, f), \
            torch.zeros((), dtype=_F32) if group_bits else None
    if n_keep is not None:
        if f % LANE:
            raise ValueError(f"packed p2p hops need F % {LANE} == 0, "
                             f"got F={f}")
        if key is None:
            raise ValueError("n_keep needs the shared exchange key")
    d_hops, h_w = send_slot.shape
    slot = send_slot.reshape(-1).long()
    valid = send_valid[..., None]
    dev = publish.device
    if pair_k is None:
        wire_bits = None
        if group_bits:
            wire_bits = mesh.all_reduce(send_valid.sum().to(_F32).reshape(
                1))[0] * float(width * 32.0)
        if n_keep is not None:
            kept, inv = _kept_maps(key, q, f, n_keep, dev)
            publish = wire_pack(publish, *_own_maps(kept, inv, me))
        rows = publish.index_select(0, slot).reshape(d_hops, h_w,
                                                     width) * valid
        return PendingHops(rows, mesh.ring_start(rows, range(1, q)), f), \
            wire_bits
    kept_np, inv_np, pos_np = worker_block_maps_pos(key, q, f // LANE,
                                                    n_keep)
    kept_me, inv_me = (_to(a[me], dev) for a in (kept_np, inv_np))
    recv = (me + np.arange(1, q)) % q
    k_d = np.asarray(pair_k)[recv, me]                         # [D]
    w_d = None if pair_w is None else \
        np.asarray(pair_w, np.float32)[recv, me]               # [D]
    rks = None
    if pair_w is not None and rounding == "stochastic":
        rks = np.stack([round_key(key, me, d) for d in range(d_hops)])
    if store_w:
        # the sub-byte hops: each quantised at its pair's qmax into
        # store_w-bit storage by one fused launch for every hop
        colmask = np.repeat(pos_np[me][None, :] < k_d[:, None], LANE,
                            axis=-1)[:, None, :]               # [D, 1, F]
        rows = publish.index_select(0, slot).reshape(d_hops, h_w, f) * valid
        if resid is not None:
            rows = rows + resid * valid
        sent = rows * _to(colmask, dev, _F32)
        bufs = pack_quant(sent, kept_me.repeat(d_hops, 1), store_w,
                          qmax=qmax_of(w_d), keys=rks)
        if resid_out is not None:
            own = unpack_quant(*bufs, inv_me.repeat(d_hops, 1), store_w)
            resid_out.append((sent - own).detach())
        if wire_out is not None:
            wire_out.append(bufs)
    else:
        packed = wire_pack(publish, kept_me, inv_me)
        cmask = _to(np.repeat(pos_np[me][kept_np[me]][None, :] <
                              k_d[:, None], LANE, axis=-1)[:, None, :],
                    dev, _F32)                                 # [D, 1, K·128]
        sent = packed.index_select(0, slot).reshape(d_hops, h_w,
                                                    width) * valid * cmask
        if pair_w is not None:
            if resid is not None:
                r_pack = wire_pack(resid.reshape(d_hops * h_w, f), kept_me,
                                   inv_me).reshape(sent.shape)
                sent = sent + r_pack * cmask * valid
            sent_q = wire_quant(sent, _to(w_d[:, None, None], dev), key=rks)
            if resid_out is not None:
                err = (sent - sent_q).detach()
                resid_out.append(wire_unpack(
                    err.reshape(d_hops * h_w, -1), inv_me, kept_me
                ).reshape(d_hops, h_w, f))
            sent = sent_q
        if wire_out is not None:
            wire_out.append((sent.detach(), None))
        bufs = sent
    wire_bits = None
    if group_bits:
        blk = np.float32(LANE * 32.0) if pair_w is None else \
            per_block_wire_bits(w_d).numpy()
        per_hop = send_valid.sum(-1).to(_F32) * _to(
            k_d.astype(np.float32), dev) * _to(blk, dev)
        wire_bits = mesh.all_reduce(per_hop.sum().reshape(1))[0]
    return PendingHops(sent, mesh.ring_start(bufs, range(1, q)), f,
                       store_w), wire_bits


def neighbor_exchange_finish(pending: PendingHops, mesh: WorkerMesh, *,
                             key=None, n_keep: int | None = None
                             ) -> torch.Tensor:
    """Completion half of :func:`neighbor_exchange`: wait for the hops,
    attach the inverse-ring gradient path, unpack each hop with its
    sender's inverse map (hop ``d`` came from worker ``rank - d``; sub-byte
    hops through ``unpack_quant``) and stack them into the compact
    ``[(Q-1)·H, F]`` halo (``[1, F]`` zeros at ``Q = 1``)."""
    q, f = mesh.q, pending.f
    if q == 1:
        return torch.zeros((1, f), dtype=_F32, device=mesh.device)
    back = tuple(-d for d in range(1, q))
    hops = mesh.ring_wait(pending.transfer)
    grad = pending.sent.requires_grad
    if n_keep is None:
        if grad:
            hops = hops + _ppermute_grad_carrier(pending.sent, mesh,
                                                 range(1, q))
        return hops.reshape(-1, f)
    dev = pending.sent.device
    kept, inv = _kept_maps(key, q, f, n_keep, dev)
    src = torch.as_tensor([(mesh.rank - d) % q for d in range(1, q)],
                          device=dev)
    if pending.store_w:
        out = unpack_quant(*hops, inv[src], pending.store_w)
        if grad:
            out = _DecodedGrad.apply(
                pending.sent, out,
                lambda g: mesh.ring_wait(mesh.ring_start(g, back)),
                kept[src], inv[mesh.rank].repeat(q - 1, 1))
        return out.reshape(-1, f)
    if grad:
        hops = hops + _ppermute_grad_carrier(pending.sent, mesh, range(1, q))
    return wire_unpack(hops, inv[src], kept[src]).reshape(-1, f)


def neighbor_exchange(publish: torch.Tensor, send_slot: torch.Tensor,
                      send_valid: torch.Tensor, mesh: WorkerMesh, *,
                      key=None, n_keep: int | None = None, **channels):
    """Neighbour-only p2p halo exchange over the ring: at offset ``d``
    this worker sends only the rows worker ``(rank + d) mod Q``
    references.  Returns ``(compact [(Q-1)·H, F], wire_bits)``;
    ``channels`` (``pair_k``, ``pair_w``, ``resid``, ``resid_out``,
    ``rounding``, ``store_w``, ``wire_out``) as in
    :func:`neighbor_exchange_start`."""
    pending, bits = neighbor_exchange_start(publish, send_slot, send_valid,
                                            mesh, key=key, n_keep=n_keep,
                                            **channels)
    return neighbor_exchange_finish(pending, mesh, key=key,
                                    n_keep=n_keep), bits
