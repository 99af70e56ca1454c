"""Partition-parallel GNN training and inference (paper Algorithm 1).

Counterpart of ``repro/dist/gnn_parallel.py``, with its two backends.
The emulated one stacks all ``Q`` partitions as ``[Q, ...]`` tensors on
one device — the JAX package's ``vmap`` over partitions written out as a
leading batch dimension.  The worker backend (the JAX package's
``shard_map`` path) runs one process per worker over ``torch.
distributed``: :func:`make_worker_mesh` / :func:`spawn_workers` build the
group, :func:`shard_graph` keeps a worker's ``[1, ...]`` block, and
``make_train_step`` / ``make_eval_step`` (and the closed loop's
``ratectl.make_auto_train_step``) take ``mesh=`` to run the same steps
over the collectives of ``repro_torch.core.collectives``.  A layer's
aggregation is

* a **local** ELL aggregation over edges whose endpoints are both owned
  (the ``ell_spmm`` kernel, one launch for all partitions; its backward
  is the same kernel over the reversed lists), plus
* a **remote** aggregation over cross edges whose source rows arrive
  through the p2p halo exchange: every sender slices one hop buffer per
  ring offset out of its boundary block, and each receiver aggregates its
  hops out of a compact halo buffer with the same kernel, over remote
  ELL lists (its backward over their reversed lists).

Wires:

* ``"dense"`` — the JAX package's default: every worker publishes its
  whole ``[B, F]`` boundary block, compressed by the policy's compressor
  (``repro_torch.core.compression``; the paper's ``randmask`` by default,
  its mask drawn on the card by the ``random_mask`` kernel), and the
  all-gather is a reshape to the ``[Q·B, F]`` halo; compression shrinks
  the ledger, not the buffer.  The local and remote edges aggregate by
  edge-list scatters, as the JAX package does.  It is also the
  evaluation wire.
* ``"packed"`` — the all-gather of the kept 128-lane blocks only
  (``varco_pack`` → ship → ``varco_unpack``), the same per-worker keys
  as ``blockmask``, so its halo is bitwise the dense ``blockmask`` halo
  (the JAX package's module note).  Under a closed-loop ``[Q, Q]`` rate
  and width map one payload serves every receiver, so each sender ships
  the maximum of its receivers' kept counts and widths (quantised
  through the fused codec when every pair quantises).
* ``"p2p"`` carries every policy — ``full``/``none``, the scalar-rate
  open-loop policies (``fixed``/``varco``: each sender packs its
  boundary block to the kept 128-lane blocks with ``varco_pack`` and the
  receiver scatters them back with ``varco_unpack``) and the closed-loop
  per-pair ``[Q, Q]`` rate and width maps (nested kept sets carved out by
  column masks; quantised pairs through the fused ``varco_pack_quant`` /
  ``varco_unpack_quant`` hop when every pair quantises, with optional
  error-feedback residuals, stochastic rounding under the JAX package's
  per-pair ``round_key`` stream, and the ``stale`` controller's hop
  reuse).

Mask indices and the per-pair bookkeeping (kept counts, column masks,
ledger rows) are tiny and computed on the host with the JAX package's key
stream (``repro_torch.prng``); the ``[Q, P, F]`` activations and the
element masks stay on the device.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core.collectives import (WorkerMesh, _gather,
                                          compressed_all_gather,
                                          neighbor_exchange_finish,
                                          neighbor_exchange_start,
                                          packed_all_gather, sender_maxima)
from repro_torch.core.varco import FULL_COMM, CommPolicy
from repro_torch.dist.halo import remote_ell
from repro_torch.kernels.ops import (WIRE_WIDTHS, ell_aggregate,
                                     per_block_wire_bits, qmax_of,
                                     quant_hop, round_key, wire_pack,
                                     wire_quant, wire_unpack)
from repro_torch.kernels.varco_pack import (LANE, worker_block_maps,
                                            worker_block_maps_pos)
from repro_torch.nn.gnn import (GNNConfig, gnn_forward,
                                masked_loss_and_correct)
from repro_torch.spans import span
from repro_torch.train.optim import (Optimizer, apply_updates, tree_leaves,
                                     tree_map)

WIRES = ("dense", "packed", "p2p")
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Static partition metadata
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistMeta:
    """Static (hashable) facts about a partitioning, shared by every step:
    sizes, the paper's ``halo_demand`` unit (distinct (requesting
    partition, remote node) pairs), each layer's input width, and — on
    the p2p wire — the hop width ``H``, compact-buffer height and ``[Q·Q]``
    per-pair halo row counts (receiver-major, diagonal 0).  Split sizes
    are global, so per-partition losses normalise identically and their
    sum's gradient is the centralized gradient."""

    q: int
    part_size: int
    halo_size: int
    num_nodes: int
    feat_dim: int
    num_classes: int
    halo_demand: int
    cross_edges: int
    n_train: int
    n_val: int
    n_test: int
    layer_dims: tuple[int, ...]
    wire: str = "p2p"
    p2p_hop_width: int = 0
    p2p_compact: int = 0
    pair_rows: tuple = ()

    def __post_init__(self):
        if self.wire not in WIRES:
            raise ValueError(f"wire must be one of {WIRES}, got "
                             f"{self.wire!r}")
        if self.wire == "packed":
            # exchanges happen at each layer's input width (layer_dims)
            for f in {self.feat_dim, *self.layer_dims}:
                if f % LANE:
                    raise ValueError(
                        f"packed wire needs every exchanged feature width "
                        f"divisible by {LANE}, got {f} (exchanged widths: "
                        f"{sorted({self.feat_dim, *self.layer_dims})}); "
                        f"use wire='dense' for off-lane-grid models")

    @staticmethod
    def build(pg, params: dict, wire: str = "p2p") -> "DistMeta":
        dims = []
        for layer in params["layers"]:
            if "self" in layer:                       # sage
                dims.append(int(layer["self"]["w"].shape[0]))
            else:                                     # poly taps
                dims.append(int(layer["taps"][0]["w"].shape[0]))
        # the per-pair facts, as JAX keeps them; a shard set
        # (repro_torch.graph.stream.ShardSet) carries its spec from the
        # manifest — after a shrink a deliberately patched one — so it is
        # taken as is, never rebuilt from the arrays
        hop_w = compact = 0
        pair_rows: tuple = ()
        if wire != "dense":
            spec = getattr(pg, "halo_spec", None)
            if spec is None:
                from repro_torch.dist.halo import build_halo_spec
                spec = build_halo_spec(pg)
            pair_rows = spec.pair_rows
            if wire == "p2p":
                hop_w, compact = spec.hop_width, spec.compact_rows
        n_train = getattr(pg, "n_train", None)
        return DistMeta(
            q=pg.q, part_size=pg.part_size, halo_size=pg.halo_size,
            num_nodes=pg.num_nodes, feat_dim=pg.feat_dim,
            num_classes=pg.num_classes, halo_demand=pg.halo_demand,
            cross_edges=pg.cross_edges,
            n_train=int(pg.train_mask.sum()) if n_train is None
            else int(n_train),
            n_val=int(pg.val_mask.sum()) if n_train is None
            else int(pg.n_val),
            n_test=int(pg.test_mask.sum()) if n_train is None
            else int(pg.n_test),
            layer_dims=tuple(dims), wire=wire,
            p2p_hop_width=hop_w, p2p_compact=compact, pair_rows=pair_rows)

    def pair_table(self) -> np.ndarray:
        """``[Q, Q]`` per-pair halo row counts (receiver × sender)."""
        if not self.pair_rows:
            raise ValueError("DistMeta.pair_rows is empty — build the meta "
                             "via DistMeta.build(..., wire='p2p')")
        return np.asarray(self.pair_rows, np.int64).reshape(self.q, self.q)

    def ledger_bits(self, feat: int, rate=1.0) -> torch.Tensor:
        """Analytic wire bits of one halo exchange at width ``feat``."""
        return torch.tensor(self.halo_demand * feat * 32.0, dtype=_F32) / \
            torch.as_tensor(rate, dtype=_F32)

    def packed_width(self, feat: int, rate: float = 1.0) -> int:
        """Columns of a packed payload: ``K·128`` with ``K = max(floor(
        (feat/128)/rate), 1)``."""
        if feat % LANE:
            raise ValueError(f"packed payloads need feat % {LANE} == 0, "
                             f"got {feat}")
        return max(int(feat // LANE / max(float(rate), 1.0)), 1) * LANE

    def _wire_width(self, feat: int, rate: float) -> int:
        """On-wire column count at ``rate``: the full rows on the dense
        wire (zeros travel too), the kept lane-blocks on the packed wire
        and on a compressing p2p exchange."""
        if self.wire == "packed" or (self.wire == "p2p" and
                                     float(rate) > 1.0):
            return self.packed_width(feat, rate)
        return feat

    def transport_bits(self, feat: int, rate: float = 1.0) -> torch.Tensor:
        """Bits the active wire ships per halo exchange, charged per
        needed boundary row (the ``halo_demand`` unit of
        :meth:`ledger_bits`)."""
        return torch.tensor(self.halo_demand * self._wire_width(feat, rate)
                            * 32.0, dtype=_F32)

    def transport_bits_quant(self, feat: int, rate: float = 1.0,
                             width: int = 32) -> torch.Tensor:
        """:meth:`transport_bits` on a quantised wire: per needed boundary
        row, each of the ``K`` kept lane-blocks charges ``128·width``
        payload bits plus one fp32 scale; ``width >= 32`` is
        :meth:`transport_bits` (fp32 ships no scales)."""
        if width >= 32:
            return self.transport_bits(feat, rate)
        k = self.packed_width(feat, rate) // LANE
        return torch.tensor(self.halo_demand * k * (LANE * width + 32.0),
                            dtype=_F32)

    def collective_bits(self, feat: int, rate: float = 1.0) -> float:
        """Bits the wire format moves per exchange, padding included: an
        all-gather wire ships every worker's padded ``[B, width]`` block
        to ``Q - 1`` peers; the p2p ring ships ``Q - 1`` padded ``[H,
        width]`` hop buffers per worker, each to one peer."""
        width = self._wire_width(feat, rate)
        if self.wire == "p2p":
            return float(self.q * max(self.q - 1, 0) *
                         self.p2p_hop_width * width * 32.0)
        return float(self.q * (self.q - 1) * self.halo_size * width * 32.0)


# ---------------------------------------------------------------------------
# Scalar-rate helpers
# ---------------------------------------------------------------------------


def _varco_blend(w: torch.Tensor, w_iso: torch.Tensor, policy: CommPolicy,
                 rate) -> torch.Tensor:
    """VARCO blends the local weights toward the isolated-subgraph
    renormalisation, ``w + (1 - 1/r)·(w_iso - w)``, so heavy early
    compression degrades toward the No-Comm operator instead of
    under-scaling every aggregation; other modes keep ``w``."""
    if policy.mode != "varco":
        return w
    mix = 1.0 - 1.0 / torch.clamp(torch.as_tensor(rate, dtype=_F32),
                                  min=1.0)
    return w + mix * (w_iso - w)


def _local_w_for(graph: dict, policy: CommPolicy, rate) -> torch.Tensor:
    """The blended edge-list weights ``[Q, E]`` (the dense wire)."""
    return _varco_blend(graph["local_w"], graph["local_w_iso"], policy, rate)


def _ell_w_for(graph: dict, policy: CommPolicy, rate) -> torch.Tensor:
    """The blended ELL weights ``[Q, P, K]`` (the p2p wire; pad entries
    are 0 in both operands, so they stay 0)."""
    return _varco_blend(graph["ell_w"], graph["ell_w_iso"], policy, rate)


def _exchange_bits(meta: DistMeta, f: int, rate,
                   wire_width: int | None = None) -> torch.Tensor:
    """Per-exchange ledger charge ``[analytic, transport]`` (float32 on
    the host); ``wire_width`` is the on-wire column count (``K·128`` when
    packed, the full ``f`` when ``None``)."""
    transport = meta.halo_demand * (f if wire_width is None
                                    else wire_width) * 32.0
    return torch.stack([meta.ledger_bits(f, rate),
                        torch.tensor(transport, dtype=_F32)])


def _keep_of(f: int, rate, packed_k: dict | None) -> int:
    """Kept-block count of a packed exchange at width ``f``: from the
    step's ``packed_k`` map when given, else from the rate directly."""
    n_blocks = f // LANE
    if packed_k is not None:
        return packed_k[n_blocks]
    return max(int(n_blocks / max(float(rate), 1.0)), 1)


def _exchanged_nbs(meta: DistMeta) -> tuple:
    """Sorted distinct lane-block counts of every exchanged width."""
    return tuple(sorted({d // LANE for d in (meta.feat_dim,
                                             *meta.layer_dims)}))


def _packed_k_for(meta: DistMeta, rate_f: float) -> tuple:
    """A concrete rate's kept-block count at every exchanged width."""
    return tuple((nb, max(int(nb / max(rate_f, 1.0)), 1))
                 for nb in _exchanged_nbs(meta))


# ---------------------------------------------------------------------------
# Per-pair rate maps — host-side static facts
# ---------------------------------------------------------------------------


def _pair_keep(nb: int, rate_map, k_max: int) -> np.ndarray:
    """Per-pair kept-block counts ``[Q, Q]`` at width ``nb·128``:
    ``max(floor(nb / r), 1)`` in float32, clamped to ``k_max``."""
    r = np.maximum(np.asarray(rate_map, np.float32), np.float32(1.0))
    k = np.maximum(np.floor(np.float32(nb) / r), np.float32(1.0))
    return np.minimum(k, np.float32(k_max)).astype(np.int32)


def _packed_pair_k_for(meta: DistMeta, rate_map) -> tuple:
    """The static maximum kept-block count of every exchanged width under
    a ``[Q, Q]`` (or ``[L, Q, Q]``) rate map: every sender packs once at
    it, and each pair's smaller kept set is carved out by column masks."""
    rm = np.maximum(np.asarray(rate_map, np.float64), 1.0)
    q = meta.q
    rm = rm.reshape(-1, q, q)
    off = ~np.eye(q, dtype=bool) if q > 1 else np.zeros((1, 1), bool)
    out = []
    for nb in _exchanged_nbs(meta):
        k = np.maximum(np.floor(nb / rm), 1.0)
        kmax = int(k[:, off].max()) if q > 1 else 1
        out.append((nb, min(max(kmax, 1), nb)))
    return tuple(out)


def _snap_width(v) -> int:
    """Snap a planned bit-width up to the nearest storage width: {2, 4, 8}
    quantised, else 32."""
    v = float(v)
    for w in WIRE_WIDTHS[:-1]:
        if v <= w:
            return w
    return 32


def _packed_pair_w_for(meta: DistMeta, width_map) -> tuple:
    """Sorted distinct sub-32 storage widths a width map realises
    off-diagonal (``()``: no pair quantises)."""
    if width_map is None or meta.q <= 1:
        return ()
    q = meta.q
    wm = np.asarray(width_map, np.float64).reshape(-1, q, q)
    off = ~np.eye(q, dtype=bool)
    ws = sorted({_snap_width(v) for v in wm[:, off].ravel()})
    return tuple(w for w in ws if w < 32)


def _packed_store_w(meta: DistMeta, width_map) -> int:
    """Sub-byte storage width: the maximum snapped off-diagonal width when
    every off-diagonal pair quantises, else 0 (some pair ships fp32)."""
    if width_map is None or meta.q <= 1:
        return 0
    q = meta.q
    wm = np.asarray(width_map, np.float64).reshape(-1, q, q)
    off = ~np.eye(q, dtype=bool)
    ws = {_snap_width(v) for v in wm[:, off].ravel()}
    if not ws or max(ws) >= 32:
        return 0
    return max(ws)


def _rate_tensor_layers(meta: DistMeta, rate_map) -> int:
    """1 for ``[Q, Q]`` pair maps, ``L`` for a per-layer ``[L, Q, Q]``
    tensor (which must match the model's layer count)."""
    nd = np.ndim(rate_map)
    if rate_map is None or nd == 2:
        return 1
    if nd != 3:
        raise ValueError(f"rate map must be [Q, Q] or [L, Q, Q], got ndim "
                         f"{nd}")
    n_layers = int(np.shape(rate_map)[0])
    if n_layers != len(meta.layer_dims):
        raise ValueError(
            f"per-layer rate tensor has {n_layers} layer rows but the model "
            f"exchanges at {len(meta.layer_dims)} layers")
    return n_layers


def _ring_targets(q: int) -> tuple[np.ndarray, np.ndarray]:
    """``(senders [Q, 1], receivers [Q, D])``: sender ``j``'s
    ring-offset-``d`` buffer goes to worker ``(j + d) mod Q``."""
    jj = np.arange(q)[:, None]
    rv = (jj + np.arange(1, max(q, 2))[None, :]) % q
    return jj, rv


def _scatter_pairs(vals_jd: torch.Tensor, q: int) -> torch.Tensor:
    """Sender-major per-hop values ``[Q, D]`` -> receiver × sender
    ``[Q, Q]`` (diagonal 0)."""
    out = torch.zeros((q, q), dtype=vals_jd.dtype, device=vals_jd.device)
    if q == 1:
        return out
    jj, rv = _ring_targets(q)
    with span("sync.halo_maps"):            # pageable copies
        jj_t = torch.as_tensor(np.broadcast_to(jj, rv.shape).copy(),
                               device=vals_jd.device)
        rv_t = torch.as_tensor(rv, device=vals_jd.device)
    out[rv_t, jj_t] = vals_jd
    return out


def _rows_of(src: torch.Tensor, idx: torch.Tensor, per: int) -> torch.Tensor:
    """Batched row gather: ``src [Q, R, F]``, ``idx [Q, ...]`` ->
    ``[Q, ..., F]`` with ``out[q, ...] = src[q, idx[q, ...]]``."""
    q = src.shape[0]
    flat = src.reshape(q * per, *src.shape[2:])
    off = (torch.arange(q, device=idx.device) * per).reshape(
        q, *([1] * (idx.dim() - 1)))
    return flat.index_select(0, (idx.long() + off).reshape(-1)).reshape(
        *idx.shape, *src.shape[2:])


def _pair_hop_energy(publish: torch.Tensor, slot: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Per-hop, per-lane-block energy of the published boundary rows:
    ``publish [Q, B, F]``, ``slot``/``valid [Q, D, H]`` -> ``[Q, D, nb]``
    summed squared values of hop ``(j, d)``'s genuine rows per block."""
    q, b, f = publish.shape
    nb = f // LANE
    be = (publish.reshape(q, b, nb, LANE).float() ** 2).sum(-1)  # [Q, B, nb]
    return (_rows_of(be, slot, b) * valid[..., None]).sum(dim=2)


def _pair_ledger(meta: DistMeta, f: int, rate_map, row_bits, pair_err,
                 pair_delta, live=None, li: int = 0, n_layers: int = 1,
                 width_map=None) -> torch.Tensor:
    """Flat per-pair ledger vector of one exchange: ``[analytic,
    transport, layer_transport (L·Q²), layer_err (L·Q²), layer_delta
    (L·Q²)]``.  ``rate_map``/``row_bits``/``live``/``width_map`` are host
    ``[Q, Q]`` arrays (the analytic and transport columns are computed in
    float32 on the host); ``pair_err``/``pair_delta`` are ``[Q, Q]``
    tensors on the data's device, where the vector is assembled."""
    f32 = torch.float32
    rows = torch.as_tensor(meta.pair_table(), dtype=f32)
    live = torch.ones_like(rows) if live is None else \
        torch.as_tensor(live, dtype=f32)
    r = torch.clamp(torch.as_tensor(rate_map, dtype=f32), min=1.0)
    w_factor = torch.tensor(1.0)
    if width_map is not None:
        w = torch.as_tensor(width_map, dtype=f32)
        w_factor = torch.where(w >= 32.0, torch.tensor(1.0), w / 32.0)
    analytic = (rows * live * f * 32.0 / r * w_factor).sum()
    pair_t = rows * live * torch.as_tensor(row_bits, dtype=f32)

    def embed(block):
        if n_layers == 1:
            return block.reshape(-1)
        out = torch.zeros((n_layers, block.numel()), dtype=block.dtype,
                          device=block.device)
        out[li] = block.reshape(-1)
        return out.reshape(-1)

    dev = pair_err.device
    host = torch.cat([torch.stack([analytic, pair_t.sum()]), embed(pair_t)])
    with span("sync.halo_bits"):           # a pageable copy
        host = host.to(dev)
    return torch.cat([host, embed(pair_err.to(f32)),
                      embed(pair_delta.to(f32))])


def _select_maps(rate_map: np.ndarray, width_map, n_layers: int, li: int):
    """Layer ``li``'s ``(rate map, ledger slice, width map)`` out of ``[Q,
    Q]`` maps or per-layer ``[L, Q, Q]`` tensors, chosen by their rank."""
    rm = rate_map if rate_map.ndim == 2 else rate_map[li]
    wm = None
    if width_map is not None:
        wm = width_map if width_map.ndim == 2 else width_map[li]
    return rm, 0 if n_layers == 1 else li, wm


def _dead_mix(meta: DistMeta, dead) -> np.ndarray:
    """Per-receiver fraction of remote halo rows served by DEAD pairs
    (``[Q]`` float32 on the host): the blend weight of the local-only
    renormalisation.  A fully dark receiver (every remote pair dead)
    lands exactly on the isolated (No-Comm) aggregation weights — the
    paper's rate→0 limit."""
    rows = meta.pair_table().astype(np.float32)
    dark = (rows * np.asarray(dead, np.float32)).sum(axis=1)
    return dark / np.maximum(rows.sum(axis=1), np.float32(1.0))


def _fault_live(q: int, fskip, dead, live):
    """Fold the fault masks into the ledger's live matrix: CACHED
    (``fskip``) and DEAD pairs ship nothing, forward or backward — both
    their analytic and transport charges go to zero."""
    if fskip is None and dead is None:
        return live
    lv = np.ones((q, q), np.float32) if live is None else \
        np.asarray(live, np.float32)
    if fskip is not None:
        lv = lv * (np.float32(1.0) - np.asarray(fskip, np.float32))
    if dead is not None:
        lv = lv * (np.float32(1.0) - np.asarray(dead, np.float32))
    return lv


# ---------------------------------------------------------------------------
# The aggregation oracle
# ---------------------------------------------------------------------------


def _scatter_rows(x: torch.Tensor, dst: torch.Tensor, src: torch.Tensor,
                  w: torch.Tensor, p_sz: int) -> torch.Tensor:
    """Per-partition edge-list aggregation ``out[q, dst] += w · x[q,
    src]`` over ``[Q, E]`` lists (pad edges point at the dropped row
    ``P``)."""
    q, _, f = x.shape
    vals = w[..., None] * _rows_of(x, src, p_sz)
    off = (torch.arange(q, device=x.device) * (p_sz + 1))[:, None]
    out = torch.zeros((q * (p_sz + 1), f), dtype=x.dtype, device=x.device)
    out = out.index_add(0, (dst.long() + off).reshape(-1),
                        vals.reshape(-1, f))
    return out.reshape(q, p_sz + 1, f)[:, :p_sz]


def _remote_scatter(vals: torch.Tensor, dst: torch.Tensor,
                    p_sz: int) -> torch.Tensor:
    """``out[q, dst] += vals`` over ``[Q, E, F]`` edge values (pad edges
    point at the dropped row ``P``) -> ``[Q, P, F]``."""
    q, _, f = vals.shape
    off = (torch.arange(q, device=vals.device) * (p_sz + 1))[:, None]
    out = torch.zeros((q * (p_sz + 1), f), dtype=vals.dtype,
                      device=vals.device).index_add(
        0, (dst.long() + off).reshape(-1), vals.reshape(-1, f))
    return out.reshape(q, p_sz + 1, f)[:, :p_sz]


def _gathered_remote(graph: dict, halo: torch.Tensor, q: int,
                     p_sz: int) -> torch.Tensor:
    """The remote edges' aggregation out of an all-gathered ``[Q·B, F]``
    halo (the dense and packed wires)."""
    vals = graph["remote_w"][..., None] * halo.index_select(
        0, graph["remote_src"].long().reshape(-1)).reshape(
            q, -1, halo.shape[-1])
    return _remote_scatter(vals, graph["remote_dst"], p_sz)


def _p2p_remote(graph: dict, compact: torch.Tensor,
                p_sz: int) -> torch.Tensor:
    """The remote edges' aggregation out of each receiver's compact
    ``[Q, C, F]`` hop buffer (the p2p wire): ``ell_spmm`` over the remote
    ELL lists ``[Q, P, Kr]`` (``repro_torch.dist.halo.remote_ell``,
    derived at a graph's first call), its backward over their reversed
    lists ``[Q, C, RKr]`` — no ``[Q, E, F]`` edge values and no atomics.
    The lists fix ``P`` (``p_sz``)."""
    del p_sz
    lists = remote_ell(graph)
    return ell_aggregate(compact, lists["remote_nbr"], lists["remote_ell_w"],
                         lists["remote_rnbr"], lists["remote_rslot"])


def _ell_local(graph: dict, x: torch.Tensor,
               ell_w: torch.Tensor) -> torch.Tensor:
    """The local edges' ELL aggregation (``ell_spmm``; its backward runs
    over the reversed lists)."""
    return ell_aggregate(x, graph["ell_nbr"], ell_w, graph["ell_rnbr"],
                         graph["ell_rslot"])


def _make_aggregate_emulated(graph: dict, meta: DistMeta, policy: CommPolicy,
                             rate, key, packed_k: dict | None = None,
                             rate_map=None, skip=None, cache=None,
                             cache_out: list | None = None,
                             width_map=None, resid=None,
                             resid_out: list | None = None,
                             store_w: int = 0, rounding: str = "rint",
                             wire_out: list | None = None,
                             fskip=None, fcache=None,
                             fcache_out: list | None = None, dead=None):
    """AggregateFn over stacked ``[Q, P, F]`` tensors on one device — the
    JAX package's ``_make_aggregate_emulated``.

    ``key`` is the step's raw key (``repro_torch.prng``); exchange
    ``call`` draws worker ``i``'s kept blocks from ``fold_in(fold_in(key,
    call), i)``.  The call counter lives in this closure, so build one
    oracle per forward (the backward never advances it).

    Without ``rate_map`` the p2p wire runs the scalar ``rate``: a
    compressing policy packs each sender's boundary block to
    ``packed_k``'s kept blocks and scatters it back; ``none`` exchanges
    nothing and aggregates local edges with the isolated weights.  A host
    ``[Q, Q]`` (or ``[L, Q, Q]``) ``rate_map`` sets each pair's kept
    count under the static maximum ``packed_k``; ``width_map`` quantises
    each pair's hop at its width — with ``store_w`` > 0 (every pair
    quantises) through the fused sub-byte hop (:func:`quant_hop`), else
    through the straight-through ``wire_quant``.  ``resid``/``resid_out``
    are the error-feedback residuals (one full-width ``[Q, D, H, F]``
    buffer per exchange): injected before quantising, replaced by the
    fresh quantisation error.  ``skip``/``cache``/``cache_out`` are the
    hop reuse of the ``stale`` controller and of serving's drift-gated
    cache: a pair with ``skip[i, j] == 1`` is served ``cache[call]``'s
    rows at zero wire bits (no cotangent reaches it), and the delivered
    hop buffers land in ``cache_out`` (detached).

    On the packed wire a rate map becomes per-SENDER rates and widths:
    one payload serves every receiver, so sender ``j`` keeps the maximum
    of its receivers' kept counts (``k_send``, columns past it zeroed)
    and quantises at their maximum width (``w_send``), through the fused
    codec on ``[Q, B, F]`` under ``store_w``; the ledger charges each
    receiver the sender's row bits.

    ``rounding="stochastic"`` rounds the quantised wire ``floor(v + u)``
    under the JAX package's keys, ``round_key(fold_in(key, call), sender,
    hop)`` on the p2p hops and ``round_key(fold_in(key, call), sender)``
    on the packed payload: into the fused codec under ``store_w``, else
    into ``wire_quant``.  ``wire_out``, a list, captures each rate-map
    exchange's shipped buffers: ``(payload uint8, scales)`` under
    ``store_w``, else ``(fp32 buffer, None)`` — sender-major ``[Q, D, H,
    ·]`` hop stacks on the p2p wire, ``[Q, B, ·]`` payloads on the packed
    wire (the ledger-vs-bytes conservation hook).

    ``fskip``/``fcache``/``fcache_out``/``dead`` are the FAULT channel
    (``repro_torch.dist.faults``), separate from the ``stale`` cache so
    degraded halo service works under every policy, on the p2p rate-map
    wire: a pair with ``fskip[i, j] == 1`` (link dropped, cache fresh
    enough) is served ``fcache[call]``'s rows and charges zero wire bits;
    ``dead[i, j] == 1`` (past the staleness cap) zeroes the pair's rows,
    charges nothing, and blends the receiver's ELL weights toward the
    isolated ones by its dark row fraction (:func:`_dead_mix`).  The
    served buffers, before the dead pairs are zeroed, land in
    ``fcache_out`` (one ``[Q, D, H, F]`` sender-major entry per exchange
    call, detached).

    The oracle carries the split-phase API: ``start(li, x) -> (token,
    bits)`` packs and ships, ``complete(li, x, token)`` runs the local
    aggregation and folds in the delivered halo.

    On the dense wire a compressing policy compresses each worker's
    published block with its compressor under ``fold_in(fold_in(key,
    call), worker)`` (the JAX package's ``vmap`` of the compressor, here
    one batched call); on the packed wire every worker ships its
    ``packed_k`` kept blocks through ``wire_pack``/``wire_unpack`` under
    the same keys.
    """
    p2p = meta.wire == "p2p"
    packed_wire = meta.wire == "packed"
    if rate_map is not None and not (p2p or packed_wire):
        raise ValueError("per-pair rate maps need wire='packed' or 'p2p'; "
                         "the dense wire keeps the scalar path")
    if rounding not in ("rint", "stochastic"):
        raise ValueError(f"rounding must be 'rint' or 'stochastic', got "
                         f"{rounding!r}")
    if resid is not None and not p2p:
        raise ValueError("error-feedback residuals are a p2p-wire feature")
    compressor = policy.compressor() if policy.compresses and \
        meta.wire == "dense" else None
    if width_map is not None and rate_map is None:
        raise ValueError("per-pair width maps ride the rate-map wire; pass "
                         "rate_map alongside width_map")
    if store_w and width_map is None:
        raise ValueError("store_w (sub-byte storage) rides the width map; "
                         "pass width_map alongside it")
    if width_map is not None:
        _rate_tensor_layers(meta, width_map)
    fault = fskip is not None or dead is not None or fcache is not None
    if fault and not (p2p and rate_map is not None):
        raise ValueError("the fault channel rides the p2p rate-map wire; "
                         "pass rate_map with wire='p2p'")
    if fcache is not None and fskip is None:
        raise ValueError("fcache is served through fskip; pass both")
    q, p_sz, b_sz = meta.q, meta.part_size, meta.halo_size
    n_layers = _rate_tensor_layers(meta, rate_map)
    if rate_map is not None:
        rate_map = np.asarray(rate_map, np.float32)
    width_map = None if width_map is None else \
        np.asarray(width_map, np.float32)
    skip = None if skip is None else np.asarray(skip, np.float32)
    fskip = None if fskip is None else np.asarray(fskip, np.float32)
    dead = None if dead is None else np.asarray(dead, np.float32)
    dev = graph["features"].device
    rate = torch.as_tensor(rate, dtype=_F32)
    jj, rv = _ring_targets(q)
    d_hops = rv.shape[1]
    calls = itertools.count()

    def to_dev(a, dtype=None):
        # a copy from pageable host memory waits for the stream
        with span("sync.halo_maps"):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

    def bits_to_dev(bits: torch.Tensor) -> torch.Tensor:
        with span("sync.halo_bits"):       # a pageable copy, as to_dev's
            return bits.to(dev)

    def hops_of(rows: torch.Tensor) -> torch.Tensor:
        """Per-pair hop buffers ``[Q, D, H, F']`` sliced out of each
        sender's ``[Q, B, F']`` rows (padding rows zeroed)."""
        return _rows_of(rows, graph["p2p_send_slot"], b_sz) * \
            graph["p2p_send_valid"][..., None]

    def pair_err_of(publish, pos_all, k_jd):
        """Per-pair dropped-block energy ``[Q, Q]``: ``k_jd [Q, D]`` is
        the kept count governing hop ``(j, d)``."""
        if "p2p_send_slot" not in graph:
            return torch.zeros((q, q), dtype=_F32, device=dev)
        energy = _pair_hop_energy(publish.detach(), graph["p2p_send_slot"],
                                  graph["p2p_send_valid"])   # [Q, D, nb]
        dropped = to_dev(pos_all[:, None, :] >= k_jd[:, :, None], _F32)
        return _scatter_pairs((energy * dropped).sum(-1), q)

    def start_rate_map(li, publish, call):
        """The per-pair rate-map hop path: ``(sent [Q, D, H, F], ledger
        vector)``."""
        f = publish.shape[-1]
        rm, lix, wm = _select_maps(rate_map, width_map, n_layers, li)
        nb = f // LANE
        n_keep = _keep_of(f, rate, packed_k)
        with span("halo.keys"):
            k_call = prng.fold_in(key, call)
            kept, inv, pos_all = worker_block_maps_pos(k_call, q, nb, n_keep)
            kept_t, inv_t = to_dev(kept), to_dev(inv)
            rks = None
            if wm is not None and rounding == "stochastic":
                # one rounding stream per (sender, ring hop)
                rks = np.stack([[round_key(k_call, j, d)
                                 for d in range(d_hops)]
                                for j in range(q)])              # [Q, D, 2]
        pos_kept = np.take_along_axis(pos_all, kept, axis=1)     # [Q, K]
        k_pairs = _pair_keep(nb, rm, n_keep)                     # [Q, Q]
        k_jd = k_pairs[rv, jj]                                   # [Q, D]
        valid = graph["p2p_send_valid"][..., None]
        if wm is not None and store_w:
            # sub-byte wire: each (sender, hop) row block is quantised at
            # its pair's width into store_w-bit storage and rebuilt from
            # those bytes alone — one fused launch each way for all hops
            colmask = np.repeat(pos_all[:, None, :] < k_jd[..., None],
                                LANE, axis=-1)[:, :, None, :]    # [Q,D,1,F]
            rows = hops_of(publish)
            if resid is not None:
                rows = rows + resid[call] * valid
            pre = rows * to_dev(colmask, _F32)
            h_w = pre.shape[2]
            qmax = qmax_of(wm[rv, jj]).reshape(-1)               # [Q·D]
            shipped: list | None = [] if wire_out is not None else None
            sent = quant_hop(pre.reshape(q * d_hops, h_w, f),
                             to_dev(np.repeat(kept, d_hops, axis=0)),
                             to_dev(np.repeat(inv, d_hops, axis=0)),
                             qmax, store_w,
                             keys=None if rks is None else rks.reshape(-1, 2),
                             wire_out=shipped).reshape(q, d_hops, h_w, f)
            if shipped is not None:
                payload, scales = shipped[0]
                wire_out.append((payload.reshape(q, d_hops, h_w, -1),
                                 scales.reshape(q, d_hops, h_w, -1)))
            if resid_out is not None:
                resid_out.append((pre - sent).detach())
        else:
            packed = wire_pack(publish, kept_t, inv_t)
            hops = hops_of(packed)                      # [Q, D, H, K·128]
            cmask = (pos_kept[:, None, :] < k_jd[..., None])     # [Q, D, K]
            cmask_l = to_dev(np.repeat(cmask, LANE, axis=-1)
                             [:, :, None, :], _F32)
            hops = hops * cmask_l
            h_w = hops.shape[2]
            if wm is not None:
                w_jd = to_dev(wm[rv, jj][:, :, None, None])      # [Q,D,1,1]
                if resid is not None:
                    r_pack = wire_pack(
                        resid[call].reshape(q, d_hops * h_w, f), kept_t,
                        inv_t).reshape(hops.shape)
                    hops = hops + r_pack * cmask_l * valid
                hops_q = wire_quant(hops, w_jd, key=rks)
                if resid_out is not None:
                    err = (hops - hops_q).detach()
                    resid_out.append(wire_unpack(
                        err.reshape(q, d_hops * h_w, -1), inv_t, kept_t
                    ).reshape(q, d_hops, h_w, f))
                hops = hops_q
            if wire_out is not None:
                wire_out.append((hops.detach(), None))
            sent = wire_unpack(hops.reshape(q, d_hops * h_w, -1), inv_t,
                               kept_t).reshape(q, d_hops, h_w, f)
        pair_err = pair_err_of(publish, pos_all, k_jd)
        pair_delta = torch.zeros((q, q), dtype=_F32, device=dev)
        live = None
        if cache is not None:
            c = cache[call]
            fresh = sent.detach()
            num = ((fresh - c) ** 2).sum(dim=(-1, -2))
            den = (fresh ** 2).sum(dim=(-1, -2)) + 1e-12
            pair_delta = _scatter_pairs(num / den, q)
            sk = skip[rv, jj]                                    # [Q, D]
            if sk.any():
                sent = torch.where(to_dev(sk[..., None, None] > 0.0), c,
                                   sent)
            live = 1.0 - skip
        if fcache is not None:
            # fault channel: dropped-but-fresh pairs serve the receiver's
            # cached hop rows (zero wire bits, no cotangent)
            fsk = fskip[rv, jj]                                  # [Q, D]
            if fsk.any():
                sent = torch.where(to_dev(fsk[..., None, None] > 0.0),
                                   fcache[call], sent)
        if fcache_out is not None:
            fcache_out.append(sent.detach())
        if cache_out is not None:
            cache_out.append(sent.detach())
        if dead is not None:
            # past the staleness cap the pair ships nothing: its rows
            # zero out and `complete` renormalises toward w_iso
            dd = dead[rv, jj]                                    # [Q, D]
            if dd.any():
                sent = torch.where(to_dev(dd[..., None, None] > 0.0),
                                   torch.zeros((), dtype=sent.dtype,
                                               device=dev), sent)
        live = _fault_live(q, fskip, dead, live)
        row_bits = k_pairs.astype(np.float32) * (
            per_block_wire_bits(wm).numpy() if wm is not None
            else np.float32(LANE * 32.0))
        bits = _pair_ledger(meta, f, rm, row_bits, pair_err, pair_delta,
                            live=live, li=lix, n_layers=n_layers,
                            width_map=wm)
        return sent, bits

    def start_packed_rate_map(li, publish, call):
        """The packed all-gather under a rate map: one payload per sender
        at the maximum of its receivers' kept counts and widths.  Returns
        ``(delivered [Q, B, F], ledger vector)``."""
        f = publish.shape[-1]
        rm, lix, wm = _select_maps(rate_map, width_map, n_layers, li)
        nb = f // LANE
        n_keep = _keep_of(f, rate, packed_k)
        with span("halo.keys"):
            k_call = prng.fold_in(key, call)
            kept, inv, pos_all = worker_block_maps_pos(k_call, q, nb, n_keep)
            kept_t, inv_t = to_dev(kept), to_dev(inv)
            rks = None
            if wm is not None and rounding == "stochastic":
                rks = np.stack([round_key(k_call, j) for j in range(q)])
        pos_kept = np.take_along_axis(pos_all, kept, axis=1)     # [Q, K]
        k_pairs = _pair_keep(nb, rm, n_keep)
        k_send, w_send = sender_maxima(k_pairs, wm)              # [Q]
        if wm is not None and store_w:
            # sub-byte all-gather: the fused codec on [Q, B, F], each
            # sender at its own qmax under the storage width
            colmask = np.repeat(pos_all < k_send[:, None], LANE,
                                axis=-1)[:, None, :]             # [Q, 1, F]
            sent = quant_hop(publish * to_dev(colmask, _F32), kept_t, inv_t,
                             qmax_of(w_send), store_w, keys=rks,
                             wire_out=wire_out)
        else:
            cmask = np.repeat(pos_kept < k_send[:, None], LANE, axis=-1)
            packed = wire_pack(publish, kept_t, inv_t) * \
                to_dev(cmask[:, None, :], _F32)
            if wm is not None:
                packed = wire_quant(packed, to_dev(w_send[:, None, None]),
                                    key=rks)
            if wire_out is not None:
                wire_out.append((packed.detach(), None))
            sent = wire_unpack(packed, inv_t, kept_t)
        k_jd = np.broadcast_to(k_send[:, None], (q, d_hops))
        pair_err = pair_err_of(publish, pos_all, k_jd)
        per_row = k_send.astype(np.float32) * (
            per_block_wire_bits(w_send).numpy() if wm is not None
            else np.float32(LANE * 32.0))
        row_bits = np.tile(per_row, (q, 1))       # receiver × sender
        bits = _pair_ledger(meta, f, rm, row_bits, pair_err,
                            torch.zeros((q, q), dtype=_F32, device=dev),
                            li=lix, n_layers=n_layers, width_map=wm)
        return sent, bits

    def start(li, x):                                  # x: [Q, P, F]
        """Issue layer ``li``'s exchange: pack, mask, ship.  Returns
        ``(halo token, ledger vector)``."""
        call = next(calls)
        f = x.shape[-1]
        if not policy.communicates:                    # No-Comm baseline
            return None, torch.zeros((2,), dtype=_F32, device=dev)
        publish = _rows_of(x, graph["send_idx"], p_sz) * \
            graph["send_valid"][..., None]             # [Q, B, F]
        if packed_wire and rate_map is not None:
            sent, bits = start_packed_rate_map(li, publish, call)
            return sent.reshape(q * b_sz, f), bits
        if not p2p:                   # the all-gather wires: a reshape
            wire_width = None
            if packed_wire:
                n_keep = _keep_of(f, rate, packed_k)
                wire_width = n_keep * LANE
                with span("halo.keys"):
                    kept, inv = worker_block_maps(prng.fold_in(key, call),
                                                  q, f // LANE, n_keep)
                    kept_t, inv_t = to_dev(kept), to_dev(inv)
                publish = wire_unpack(wire_pack(publish, kept_t, inv_t),
                                      inv_t, kept_t)
            elif compressor is not None:
                with span("halo.keys"):
                    k_call = prng.fold_in(key, call)
                    keys = np.stack([prng.fold_in(k_call, j)
                                     for j in range(q)])
                publish = compressor.batched(keys, publish, rate)[0]
            return publish.reshape(q * b_sz, f), \
                bits_to_dev(_exchange_bits(meta, f, rate, wire_width))
        if rate_map is not None:
            sent, bits = start_rate_map(li, publish, call)
        else:
            wire_width = None
            if policy.compresses:
                n_keep = _keep_of(f, rate, packed_k)
                wire_width = n_keep * LANE
                with span("halo.keys"):
                    kept, inv = worker_block_maps(prng.fold_in(key, call),
                                                  q, f // LANE, n_keep)
                    kept_t, inv_t = to_dev(kept), to_dev(inv)
                publish = wire_unpack(wire_pack(publish, kept_t, inv_t),
                                      inv_t, kept_t)
            sent = hops_of(publish)                    # [Q, D, H, F]
            bits = bits_to_dev(_exchange_bits(meta, f, rate, wire_width))
        # route: receiver i's hop-d rows come from worker (i - d) mod q
        if q > 1:
            src_w = (np.arange(q)[:, None] - np.arange(1, q)[None, :]) % q
            compact = sent[to_dev(src_w), to_dev(np.arange(q - 1)[None, :])
                           ].reshape(q, meta.p2p_compact, f)
        else:
            compact = torch.zeros((q, meta.p2p_compact, f), dtype=x.dtype,
                                  device=dev)
        return compact, bits

    def complete(li, x, token):
        """Consume layer ``li``'s delivered halo: the local aggregation
        (ELL on the p2p wire) plus the remote aggregation out of the
        token (ELL over the compact buffer on the p2p wire)."""
        del li
        if not policy.communicates:                    # No-Comm baseline
            return _scatter_rows(x, graph["local_dst"], graph["local_src"],
                                 graph["local_w_iso"], p_sz)
        if not p2p:
            local = _scatter_rows(x, graph["local_dst"], graph["local_src"],
                                  _local_w_for(graph, policy, rate), p_sz)
            return local + _gathered_remote(graph, token, q, p_sz)
        ell_w = _ell_w_for(graph, policy, rate)
        if dead is not None:
            # local-only fallback: blend each receiver's weights toward
            # the isolated normalisation by its dark remote-row fraction
            # (every pair dead → exactly No-Comm), still on ell_spmm
            mix = to_dev(_dead_mix(meta, dead))[:, None, None]
            ell_w = ell_w + mix * (graph["ell_w_iso"] - ell_w)
        return _ell_local(graph, x, ell_w) + _p2p_remote(graph, token, p_sz)

    def aggregate(li, x):
        token, bits = start(li, x)
        return complete(li, x, token), bits

    aggregate.start = start
    aggregate.complete = complete
    return aggregate


# ---------------------------------------------------------------------------
# The worker group: one process per worker over torch.distributed
# ---------------------------------------------------------------------------


def _group_backend(q: int, device: torch.device, backend: str | None
                   ) -> str:
    """The backend a ``q``-worker group on ``device`` runs over, checked:
    ``nccl`` on the card needs a card per worker (NCCL refuses two ranks
    on one card), and nothing switches backend on its own."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a worker group was asked for CUDA devices but torch.cuda."
            "is_available() is False; pass device='cpu' to run the workers "
            "on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"workers run on 'cuda' or 'cpu', got {device}")
    if backend is None:
        if dist.is_available() and dist.is_initialized():
            backend = dist.get_backend()
        else:
            backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend='nccl' needs CUDA devices; workers on "
                             "the CPU run over backend='gloo'")
        n = torch.cuda.device_count()
        if n < q:
            raise ValueError(
                f"backend='nccl' needs a card per worker: {q} workers, {n} "
                f"card(s), and NCCL refuses two ranks on one card; pass "
                f"backend='gloo' to share cards, every transfer staged "
                f"through pinned host memory")
    return backend


def make_worker_mesh(q: int, device="cuda", backend: str | None = None,
                     timeout: datetime.timedelta | None = None
                     ) -> WorkerMesh:
    """This process's :class:`~repro_torch.core.collectives.WorkerMesh` in
    the initialised default process group of world size ``q`` (from
    ``torchrun`` or :func:`spawn_workers`): the JAX package's
    ``make_worker_mesh``, one process per worker.

    The worker's device is ``cuda:{rank % device_count}`` (``device=
    "cuda"``), the given card, or the CPU.  ``backend`` defaults to the
    group's; ``"gloo"`` with CUDA tensors stages every transfer through
    pinned host buffers, and ``"nccl"`` with two workers on one card
    raises.  ``timeout`` is the per-operation timeout the group was
    started with, which the subgroups of :func:`shrink_mesh` take too
    (``None``: ``torch.distributed``'s default).

    Example (under ``torchrun --nproc_per_node 4``)::

        dist.init_process_group("nccl")
        mesh = make_worker_mesh(4)
        step = make_train_step(cfg, policy, opt, meta, mesh=mesh)
    """
    device = torch.device(device)
    backend = _group_backend(q, device, backend)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_worker_mesh needs an initialised process group of world "
            f"size {q}: start the workers with torchrun, or with "
            f"repro_torch.dist.gnn_parallel.spawn_workers")
    if dist.get_world_size() != q:
        raise ValueError(f"need {q} workers, the process group has "
                         f"{dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not backend={backend!r}")
    rank = dist.get_rank()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return WorkerMesh(q=q, rank=rank, device=device, backend=backend,
                      timeout=timeout)


def shrink_mesh(mesh: WorkerMesh, dead: int) -> WorkerMesh | None:
    """The mesh of the workers that survive the crash of worker ``dead``
    (its rank in ``mesh``): every process of ``mesh`` calls it, the
    crashed one too, since ``torch.distributed`` creates the survivors'
    subgroup collectively over the whole job.  Survivors are renumbered
    ``r - (r > dead)``, as ``repro_torch.dist.faults.shrink_shards``
    renumbers the partitions, and keep the transport counters; the
    crashed worker gets ``None``.  The subgroup ``mesh`` ran on, if any,
    is destroyed.  A process that left an earlier mesh takes part in the
    later subgroups through :func:`follow_shrink`, and every process ends
    the run with :func:`leave_group`.

    Example::

        mesh = shrink_mesh(mesh, crash)
        if mesh is None:
            ...                      # this worker crashed: it trains no more
    """
    if not 0 <= dead < mesh.q:
        raise ValueError(f"dead worker {dead} out of range for a mesh of "
                         f"{mesh.q}")
    if mesh.q < 2:
        raise ValueError("cannot shrink a mesh below one worker")
    survivors, group = follow_shrink(mesh.ranks, dead, mesh.timeout)
    if mesh.group is not None:
        dist.destroy_process_group(mesh.group)
    if mesh.rank == dead:
        return None
    return dataclasses.replace(
        mesh, q=mesh.q - 1, rank=survivors.index(mesh.ranks[mesh.rank]),
        group=group, ranks=survivors)


def follow_shrink(ranks: tuple, dead: int,
                  timeout: datetime.timedelta | None = None) -> tuple:
    """``(survivors' job-wide ranks, their subgroup)`` when worker
    ``dead`` of a mesh with job-wide ``ranks`` crashes.  A process that is
    no longer a worker of the mesh (it crashed earlier) calls it at each
    later crash of the run: ``torch.distributed`` creates every subgroup
    over the whole job and names it by a count each process keeps.  (A
    subgroup its members create alone is named by a hash of their ranks
    instead; that name returns when the same workers survive a later
    run's crash, and under ``gloo`` the new group then reads the
    destroyed one's addresses from the store and hangs.)"""
    survivors = ranks[:dead] + ranks[dead + 1:]
    return survivors, dist.new_group(ranks=list(survivors), timeout=timeout)


#: the job-store key by which rank 0 of a shrunk mesh tells the crashed
#: workers that the run is over
_RUN_DONE = "repro_torch/run_done"


def leave_group(mesh: WorkerMesh | None) -> None:
    """End a run on the worker group: every process of the job calls it,
    a crashed worker with ``None``.  The crashed workers stay until the
    survivors are done (the job's store may live in any process), but not
    in an operation on the group, which its timeout would end however long
    the survivors still train: they poll the store for :data:`_RUN_DONE`,
    which rank 0 of a shrunk mesh sets, and need no bound of their own
    (the spawner or launcher ends the job when a survivor fails).  Then
    every process meets in one barrier of the job, and the survivors
    destroy their subgroup."""
    store = dist.distributed_c10d._get_default_store()
    shrunk = mesh is None or mesh.q < dist.get_world_size()
    if mesh is None:
        while not store.check([_RUN_DONE]):
            time.sleep(0.05)
    elif shrunk and mesh.rank == 0:
        store.set(_RUN_DONE, "1")
    dist.barrier()
    if mesh is not None:
        if mesh.group is not None:
            dist.destroy_process_group(mesh.group)
        if shrunk and mesh.rank == 0:
            store.delete_key(_RUN_DONE)     # every crashed worker has read it


def _spawned_worker(rank: int, fn, q: int, args: tuple, device: str,
                    backend: str, timeout: float, tmp: str) -> None:
    """One spawned worker: join the group, run ``fn(mesh, *args)``, leave
    its result (unless ``None``) or its exception in ``tmp``."""
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=q, timeout=timeout)
    try:
        mesh = make_worker_mesh(q, device, backend, timeout)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)   # before any collective
        out = fn(mesh, *args)
        if out is not None:
            torch.save(out, os.path.join(tmp, f"result_{rank}"))
    except BaseException as exc:
        try:
            with open(os.path.join(tmp, f"error_{rank}"), "wb") as fh:
                pickle.dump(exc, fh)
        except (pickle.PicklingError, TypeError, AttributeError):
            pass                      # the parent reports the traceback
        raise
    finally:
        dist.destroy_process_group()


def spawn_workers(fn, q: int, *args, device="cuda",
                  backend: str | None = None, timeout: float = 60.0):
    """Run ``fn(mesh, *args)`` in ``q`` new worker processes, one per
    worker (``torch.multiprocessing.spawn``), joined in a process group
    through a ``file://`` store in a temporary directory, and return the
    result of the lowest rank whose ``fn`` returned something other than
    ``None`` (else ``None``): under ``train_gnn``, that of rank 0 of the
    final mesh, since a worker that crashed returns ``None``.

    ``fn`` must be importable by name (the workers start from a fresh
    interpreter) and ``args`` picklable.  ``device``/``backend`` are
    :func:`make_worker_mesh`'s; ``timeout`` (seconds) bounds every wait
    on the group, so a hung hop fails instead of hanging.  Each worker
    runs one CPU thread.  A worker's exception is re-raised here (the
    first one raised, chained to the spawn error)."""
    from torch.multiprocessing import spawn
    from torch.multiprocessing.spawn import ProcessException

    device = torch.device(device)
    backend = _group_backend(q, device, backend)
    try:
        pickle.dumps((fn, args))
    except (pickle.PicklingError, AttributeError, TypeError) as err:
        raise TypeError(
            f"spawn_workers pickles fn and its arguments into the new "
            f"processes, and cannot: {err}; pass module-level functions "
            f"and picklable values (an optimiser is a closure: let the "
            f"worker build it)") from err
    with tempfile.TemporaryDirectory(prefix="repro_torch_workers_") as tmp:
        try:
            spawn(_spawned_worker, args=(fn, q, args, str(device), backend,
                                         timeout, tmp), nprocs=q, join=True)
        except ProcessException as err:
            errors = sorted((e for e in os.scandir(tmp)
                             if e.name.startswith("error_")),
                            key=lambda e: e.stat().st_mtime_ns)
            if errors:
                with open(errors[0].path, "rb") as fh:
                    raise pickle.load(fh) from err
            raise
        first = min((e for e in os.scandir(tmp)
                     if e.name.startswith("result_")),
                    key=lambda e: int(e.name[len("result_"):]), default=None)
        return None if first is None else \
            torch.load(first.path, weights_only=False)


def shard_graph(graph: dict, mesh: WorkerMesh) -> dict:
    """This worker's ``[1, ...]`` row of every stacked ``[Q, ...]`` graph
    leaf (the p2p halo and ELL lists included), on ``mesh.device``: the
    JAX package's ``shard_graph`` with the validation of
    ``worker_graph_shardings`` — a leaf whose leading dimension is not
    ``Q`` is rejected with its key named.

    Example::

        graph = shard_graph(attach_p2p(pg.device_arrays("cpu"), pg, "cpu"),
                            make_worker_mesh(pg.q))
    """
    for k, v in graph.items():
        shape = tuple(getattr(v, "shape", ()))
        if not shape or shape[0] != mesh.q:
            raise ValueError(
                f"graph leaf {k!r} has shape {shape}; expected a stacked "
                f"[Q, ...] tensor with Q == {mesh.q} workers")
    r = mesh.rank
    return {k: v[r:r + 1].to(mesh.device, copy=True)
            for k, v in graph.items()}


def _make_aggregate_shard(graph: dict, meta: DistMeta, policy: CommPolicy,
                          rate, key, mesh: WorkerMesh,
                          packed_k: dict | None = None, rate_map=None,
                          width_map=None, resid=None,
                          resid_out: list | None = None, fskip=None,
                          fcache=None, fcache_out: list | None = None,
                          dead=None, rounding: str = "rint",
                          store_w: int = 0, wire_out: list | None = None):
    """AggregateFn of one worker of ``mesh`` (blocks ``[1, P, F]``): the
    JAX package's ``_make_aggregate_shard``.

    Dense wire: :func:`~repro_torch.core.collectives.compressed_all_gather`
    under the policy's compressor (the ``random_mask`` kernel for the
    paper's ``randmask``), or a plain all-gather at full communication.
    Packed wire: :func:`~repro_torch.core.collectives.packed_all_gather`
    at ``packed_k``'s kept blocks.  P2P wire: the ``Q - 1`` ring hops of
    :func:`~repro_torch.core.collectives.neighbor_exchange_start`, packed
    under a compressing policy, with the local edges on ``ell_spmm``.
    The collectives' own bit counts are skipped (``group_bits=False``):
    the ledger is computed on the host, ``_exchange_bits`` or the
    per-pair ``_pair_ledger``.  Worker ``i`` draws its kept blocks and
    masks from ``fold_in(fold_in(key, call), i)``, the emulated backend's
    streams, so the two backends' halos agree bitwise, and the ledger is
    the emulated one.

    A host ``[Q, Q]`` (or per-layer ``[L, Q, Q]``) ``rate_map``, with an
    optional ``width_map`` and ``store_w``, runs the closed loop's
    channels of the p2p and packed collectives at the emulated backend's
    kept counts, widths and ``rounding`` streams.  The per-pair ledger's
    ``pair_err`` is this worker's dropped-block energy per hop,
    all-gathered into the ``[Q, Q]`` matrix, so every worker's ledger is
    the same bytes.  ``resid``/``resid_out`` are the error-feedback
    residuals on the p2p wire: one ``[1, D, H, F]`` slab of this worker
    per exchange call (its row of the emulated ``[Q, D, H, F]`` state).
    ``wire_out``, a list, receives this worker's shipped buffers per
    rate-map exchange.

    ``fskip``/``fcache``/``fcache_out``/``dead`` are the fault channel on
    the p2p rate-map wire, served on the receiver's side after
    ``neighbor_exchange_finish``: the ring still posts every hop (a fault
    means delivery failed, not that the hop was never posted), and this
    worker replaces the rows of a CACHED pair (``fskip[rank, src]``) by
    its ``fcache[call][0]`` block and zeroes a DEAD pair's, while the
    ledger charges neither.  ``fcache`` holds this worker's ``[1, D, H,
    F]`` receiver-major block per exchange call (hop ``d`` what it got
    from worker ``(rank - d) mod Q``: row ``rank`` of ``faults.
    _cache_send_to_recv`` of the emulated sender-major cache), and each
    call appends the served block, before DEAD pairs are zeroed, to
    ``fcache_out``.  DEAD pairs blend this worker's ELL weights toward the
    isolated ones by ``_dead_mix``, as on the emulated backend.

    The same ``start``/``complete`` split as the emulated oracle: on the
    p2p wire ``start`` posts the hops and ``complete`` runs the ELL local
    aggregation before it waits for them."""
    if mesh.q != meta.q:
        raise ValueError(f"the mesh has {mesh.q} workers, the partitioning "
                         f"{meta.q}")
    p2p = meta.wire == "p2p"
    packed_wire = meta.wire == "packed"
    if rate_map is not None and not (p2p or packed_wire):
        raise ValueError("per-pair rate maps need wire='packed' or 'p2p'; "
                         "the dense wire keeps the scalar path")
    if width_map is not None and rate_map is None:
        raise ValueError("per-pair width maps ride the rate-map wire; pass "
                         "rate_map alongside width_map")
    if resid is not None and not (p2p and width_map is not None):
        raise ValueError("error-feedback residuals ride the quantised p2p "
                         "wire; pass width_map with wire='p2p'")
    if store_w and width_map is None:
        raise ValueError("store_w (sub-byte storage) rides the width map; "
                         "pass width_map alongside it")
    if (fskip is not None or fcache is not None or dead is not None) and \
            not (p2p and rate_map is not None):
        raise ValueError("the fault channel rides the p2p rate-map wire; "
                         "pass rate_map with wire='p2p'")
    if fcache is not None and fskip is None:
        raise ValueError("fcache is served through fskip; pass both")
    fskip = None if fskip is None else np.asarray(fskip, np.float32)
    dead = None if dead is None else np.asarray(dead, np.float32)
    n_layers = _rate_tensor_layers(meta, rate_map)
    if width_map is not None:
        _rate_tensor_layers(meta, width_map)
        width_map = np.asarray(width_map, np.float32)
    if rate_map is not None:
        rate_map = np.asarray(rate_map, np.float32)
    compressor = policy.compressor() if policy.compresses and \
        meta.wire == "dense" else None
    q, p_sz, b_sz, me = meta.q, meta.part_size, meta.halo_size, mesh.rank
    d_hops = max(q - 1, 1)
    dev = graph["features"].device
    rate = torch.as_tensor(rate, dtype=_F32)
    calls = itertools.count()

    def pair_err_of(publish, pos_me, k_d):
        """The replicated ``[Q, Q]`` dropped-block energy: this worker's
        per hop ``[D]`` (``k_d`` the kept count governing each of its
        hops), all-gathered."""
        if "p2p_send_slot" not in graph:
            return torch.zeros((q, q), dtype=_F32, device=dev)
        energy = _pair_hop_energy(publish.detach()[None],
                                  graph["p2p_send_slot"],
                                  graph["p2p_send_valid"])[0]  # [D, nb]
        dropped = torch.as_tensor(pos_me[None, :] >= k_d[:, None],
                                  dtype=_F32, device=dev)
        return _scatter_pairs(mesh.all_gather((energy * dropped).sum(-1)),
                              q)

    def start_rate_map(li, publish, call):
        """The rate-map exchange of this worker: ``(token, ledger
        vector)``."""
        f = publish.shape[-1]
        rm, lix, wm = _select_maps(rate_map, width_map, n_layers, li)
        nb = f // LANE
        n_keep = _keep_of(f, rate, packed_k)
        k_call = prng.fold_in(key, call)
        k_pairs = _pair_keep(nb, rm, n_keep)                     # [Q, Q]
        pos_me = worker_block_maps_pos(k_call, q, nb, n_keep)[2][me]
        sw = store_w if wm is not None else 0
        if p2p:
            r_out: list = []
            pending, _ = neighbor_exchange_start(
                publish, graph["p2p_send_slot"][0],
                graph["p2p_send_valid"][0], mesh, key=k_call,
                n_keep=n_keep, pair_k=k_pairs, pair_w=wm,
                resid=None if resid is None else resid[call][0],
                resid_out=None if resid is None else r_out,
                rounding=rounding, store_w=sw, wire_out=wire_out,
                group_bits=False)
            if resid is not None and resid_out is not None:
                resid_out.append(r_out[0][None] if r_out else resid[call])
            token = (pending, k_call, n_keep, call)
            k_d = k_pairs[(me + np.arange(1, d_hops + 1)) % q, me]
            row_bits = k_pairs.astype(np.float32) * (
                per_block_wire_bits(wm).numpy() if wm is not None
                else np.float32(LANE * 32.0))
        else:
            halo, _ = packed_all_gather(
                publish, mesh, key=k_call, n_keep=n_keep, pair_k=k_pairs,
                pair_w=wm, rounding=rounding, store_w=sw, wire_out=wire_out)
            token = halo.reshape(q * b_sz, f)
            k_send, w_send = sender_maxima(k_pairs, wm)
            k_d = np.full(d_hops, k_send[me])
            row_bits = np.tile(k_send.astype(np.float32) * (
                per_block_wire_bits(w_send).numpy() if wm is not None
                else np.float32(LANE * 32.0)), (q, 1))
        bits = _pair_ledger(meta, f, rm, row_bits,
                            pair_err_of(publish, pos_me, k_d),
                            torch.zeros((q, q), dtype=_F32, device=dev),
                            live=_fault_live(q, fskip, dead, None),
                            li=lix, n_layers=n_layers, width_map=wm)
        return token, bits

    def serve_faults(hops, call):
        """The fault channel on this worker's received ``[D, H, F]`` hops
        (hop ``d`` from worker ``(rank - d - 1) mod Q``): CACHED pairs
        served from the cache, the served block kept, DEAD pairs
        zeroed."""
        src = (me - np.arange(1, q)) % q
        if fcache is not None:
            fsk = fskip[me, src]
            if fsk.any():
                hops = torch.where(torch.as_tensor(
                    fsk[:, None, None] > 0.0, device=dev),
                    fcache[call][0], hops)
        if fcache_out is not None:
            fcache_out.append(hops.detach()[None])
        if dead is not None:
            dd = dead[me, src]
            if dd.any():
                hops = torch.where(torch.as_tensor(
                    dd[:, None, None] > 0.0, device=dev),
                    torch.zeros((), dtype=hops.dtype, device=dev), hops)
        return hops

    def start(li, x):                                  # x: [1, P, F]
        """Issue layer ``li``'s exchange on this worker.  Returns
        ``(token, ledger)``: the posted hops on the p2p wire, the gathered
        ``[Q·B, F]`` halo on the others."""
        call = next(calls)
        f = x.shape[-1]
        if not policy.communicates:
            return None, torch.zeros((2,), dtype=_F32, device=dev)
        publish = (_rows_of(x, graph["send_idx"], p_sz) *
                   graph["send_valid"][..., None])[0]  # [B, F]
        if rate_map is not None:
            return start_rate_map(li, publish, call)
        n_keep = wire_width = k_call = None
        if packed_wire or (p2p and policy.compresses):
            n_keep = _keep_of(f, rate, packed_k)
            wire_width = n_keep * LANE
        if packed_wire or policy.compresses:
            k_call = prng.fold_in(key, call)
        with span("sync.halo_bits"):
            bits = _exchange_bits(meta, f, rate, wire_width).to(dev)
        if p2p:
            pending, _ = neighbor_exchange_start(
                publish, graph["p2p_send_slot"][0],
                graph["p2p_send_valid"][0], mesh, key=k_call,
                n_keep=n_keep, group_bits=False)
            return (pending, k_call, n_keep, call), bits
        if packed_wire:
            halo, _ = packed_all_gather(publish, mesh, key=k_call,
                                        n_keep=n_keep)
        elif compressor is not None:
            halo, _ = compressed_all_gather(
                publish, mesh, compressor=compressor, rate=rate, key=k_call,
                group_bits=False)
        else:
            halo = _gather(publish, mesh)              # [Q, B, F]
        return halo.reshape(q * b_sz, f), bits

    def complete(li, x, token):
        """Consume layer ``li``'s exchange: the local aggregation (ELL on
        the p2p wire, before the hops are waited on) plus the remote
        aggregation (ELL over the compact buffer on the p2p wire)."""
        del li
        if not policy.communicates:                    # No-Comm baseline
            return _scatter_rows(x, graph["local_dst"], graph["local_src"],
                                 graph["local_w_iso"], p_sz)
        if not p2p:
            local = _scatter_rows(x, graph["local_dst"], graph["local_src"],
                                  _local_w_for(graph, policy, rate), p_sz)
            return local + _gathered_remote(graph, token, 1, p_sz)
        pending, k_call, n_keep, call = token
        ell_w = _ell_w_for(graph, policy, rate)
        if dead is not None:
            mix = torch.as_tensor(_dead_mix(meta, dead)[me], device=dev)
            ell_w = ell_w + mix * (graph["ell_w_iso"] - ell_w)
        loc = _ell_local(graph, x, ell_w)
        halo = neighbor_exchange_finish(pending, mesh, key=k_call,
                                        n_keep=n_keep)
        if q > 1 and (fcache is not None or dead is not None):
            halo = serve_faults(halo.reshape(d_hops, -1, halo.shape[-1]),
                                call).reshape(halo.shape)
        return loc + _p2p_remote(graph, halo[None], p_sz)

    def aggregate(li, x):
        token, bits = start(li, x)
        return complete(li, x, token), bits

    aggregate.start = start
    aggregate.complete = complete
    return aggregate


def first_halo(graph: dict, meta: DistMeta, policy: CommPolicy, key,
               x: torch.Tensor, mesh: WorkerMesh | None = None, plan=None,
               rounding: str = "rint",
               resid_out: list | None = None) -> torch.Tensor:
    """The halo of layer 0's exchange of ``x`` at step 0's rate, without
    autograd: what the two backends' halos are held to each other by.  The
    gathered ``[Q·B, F]`` halo on the all-gather wires; on the p2p wire
    the compact hop buffers, ``[Q, C, F]`` emulated (``mesh=None``), a
    worker's own ``[C, F]`` under ``mesh``.  ``plan`` (a ``RatePlan`` of
    ``repro_torch.dist.ratectl``) runs the exchange under its rate and
    width maps instead, as the auto step does, rounded by ``rounding``;
    ``resid_out``, a list, then receives the error-feedback residual the
    exchange leaves from zero residuals on the p2p wire (``[Q, D, H, F]``
    emulated, a worker's ``[1, D, H, F]`` slab) when the plan
    quantises."""
    kw: dict = {}
    if plan is None:
        rate = policy.rate(0) if policy.communicates else 1.0
        kb = dict(_packed_k_for(meta, float(rate)))
    else:
        from repro_torch.dist.ratectl.driver import plan_widths
        rate, rm, wm = 1.0, np.asarray(plan.rates, np.float32), \
            plan_widths(meta, plan)
        kb = dict(_packed_pair_k_for(meta, rm))
        kw = dict(rate_map=rm, width_map=wm, rounding=rounding,
                  store_w=_packed_store_w(meta, wm))
        if resid_out is not None and wm is not None and meta.wire == "p2p":
            rows = meta.q if mesh is None else 1
            kw.update(resid_out=resid_out, resid=(torch.zeros(
                (rows, max(meta.q - 1, 1), meta.p2p_hop_width,
                 x.shape[-1]), dtype=_F32, device=x.device),))
    with torch.no_grad():
        if mesh is None:
            return _make_aggregate_emulated(graph, meta, policy, rate, key,
                                            packed_k=kb, **kw).start(0, x)[0]
        token = _make_aggregate_shard(graph, meta, policy, rate, key, mesh,
                                      packed_k=kb, **kw).start(0, x)[0]
        if meta.wire != "p2p":
            return token
        pending, k_call, n_keep, _ = token
        return neighbor_exchange_finish(pending, mesh, key=k_call,
                                        n_keep=n_keep)


def _all_reduce_leaves(leaves: list, mesh: WorkerMesh) -> list:
    """Every worker's ``leaves`` summed, in leaf order: one all-reduce of
    a buffer that concatenates the leaves of each dtype."""
    out = list(leaves)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        flat = mesh.all_reduce(torch.cat([leaves[i].reshape(-1)
                                          for i in idx]))
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(leaves[i])
    return out


def _pmean_inexact(tree, mesh: WorkerMesh):
    """FedAvg's server step: the mean over the workers of every floating
    leaf; integer state (the optimiser's step count) stays local."""
    leaves = tree_leaves(tree)
    floats = [t for t in leaves if t.is_floating_point()]
    mean = iter(t / mesh.q for t in _all_reduce_leaves(floats, mesh))
    return tree_map(lambda t: next(mean) if t.is_floating_point() else t,
                    tree)


# ---------------------------------------------------------------------------
# Train, eval and inference steps
# ---------------------------------------------------------------------------


def _per(n: int) -> float:
    """``1 / max(n, 1)`` rounded to float32: the JAX package divides by
    split sizes and counts that are compile-time constants, which XLA
    turns into a multiply by the float32 reciprocal, so the port
    multiplies by the same number to round alike."""
    return float(np.float32(1.0) / np.float32(max(n, 1)))


def _value_and_grad(fn, params):
    """``((value, aux), grads)`` of ``fn(params) -> (scalar, aux)`` with
    respect to every tensor leaf of ``params`` (``jax.value_and_grad``
    with ``has_aux``); the inputs are left untouched."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with span("step.forward"):
        value, aux = fn(live)
    with span("step.backward"):
        flat = iter(torch.autograd.grad(value, tree_leaves(live)))
    return (value.detach(), aux), tree_map(lambda _: next(flat), live)


def _local_loss_fn(params, cfg: GNNConfig, graph: dict, aggregate,
                   meta: DistMeta):
    """Masked CE over owned train nodes, normalised by the GLOBAL count,
    so the per-partition losses' summed gradient is the centralized
    gradient.  Returns ``(loss, forward wire bits)``."""
    logits, bits = gnn_forward(params, cfg, graph["features"], aggregate)
    loss_sum, _ = masked_loss_and_correct(logits, graph["labels"],
                                          graph["train_mask"])
    return loss_sum * _per(meta.n_train), bits


def _step_metrics(loss, rate, bits) -> dict:
    """Common step metrics: ``bits`` is the forward ``[analytic,
    transport]`` pair; a train step ships it twice (activations +
    cotangents)."""
    with span("sync.step_metrics"):
        bits = bits.cpu()
    return {"loss": loss, "rate": torch.as_tensor(rate, dtype=_F32),
            "halo_bits": 2.0 * bits[0], "transport_bits": 2.0 * bits[1]}


def _optimize(opt: Optimizer, grads, opt_state, params):
    with torch.no_grad():
        updates, new_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), new_state


def _synced_update(opt: Optimizer, loss, grads, opt_state, params,
                   mesh: WorkerMesh | None, sync: str):
    """One update from this process's loss and gradients: ``(loss,
    params, opt_state)``.  Emulated (``mesh=None``) they are already the
    centralized ones.  On a worker the loss is all-reduced and, under
    ``sync="grad"``, the gradients too (one round trip) before one update;
    under ``"fedavg"`` the update is local and the floating parameters and
    optimiser state are averaged over the workers (Algorithm 1's server
    step)."""
    with span("step.update"):
        if mesh is not None and sync == "grad":
            # the loss rides the gradients' all-reduce: one round trip
            summed = _all_reduce_leaves(
                [loss.reshape(1), *tree_leaves(grads)], mesh)
            loss, rest = summed[0][0], iter(summed[1:])
            grads = tree_map(lambda _: next(rest), grads)
        elif mesh is not None:
            loss = mesh.all_reduce(loss.reshape(1))[0]
        new_params, new_state = _optimize(opt, grads, opt_state, params)
        if mesh is not None and sync == "fedavg":
            new_params = _pmean_inexact(new_params, mesh)
            new_state = _pmean_inexact(new_state, mesh)
        return loss, new_params, new_state


def make_train_step(cfg: GNNConfig, policy: CommPolicy, opt: Optimizer,
                    meta: DistMeta, mesh: WorkerMesh | None = None,
                    sync: str = "grad"):
    """One full-batch step of Algorithm 1.

    ``step(params, opt_state, graph, step_idx, key) -> (params, opt_state,
    {loss, rate, halo_bits, transport_bits})``.  ``mesh=None`` runs the
    emulated backend over ``[Q, ...]`` stacks on one device; with a
    :func:`make_worker_mesh` mesh each worker process runs the same step
    on its :func:`shard_graph` block over real collectives: its local loss
    and gradients, the loss all-reduced, then under ``sync="grad"`` the
    gradients all-reduced (the centralized step) and one update, under
    ``"fedavg"`` a local update and the mean of the floating parameters
    and optimiser state (Algorithm 1's server step).  On the dense wire a
    compressing policy runs its compressor (any of
    ``repro_torch.core.compression``'s).  On the packed wire, and under
    compression on the p2p wire, the schedule's rate is quantised to the
    static kept-block counts on the host (:func:`_packed_k_for`), and a
    compressing policy must use the ``blockmask`` compressor, which the
    pack/unpack kernels realise.

    Example::

        step = make_train_step(cfg, varco(300, compressor="blockmask"),
                               adamw(5e-3), meta)
        params, opt_state, m = step(params, opt_state, graph, 0,
                                    prng.key(0))
    """
    if mesh is not None and mesh.q != meta.q:
        raise ValueError(f"the mesh has {mesh.q} workers, the partitioning "
                         f"{meta.q}")
    if sync not in ("grad", "fedavg"):
        raise ValueError(f"sync must be 'grad' or 'fedavg', got {sync!r}")
    if policy.mode == "auto":
        raise ValueError(
            "auto policies plan per-pair rate maps closed-loop; build the "
            "step with repro_torch.dist.ratectl.make_auto_train_step "
            "(train_gnn routes there automatically)")
    p2p = meta.wire == "p2p"
    packed_wire = meta.wire == "packed"
    if (packed_wire or p2p) and policy.compresses and \
            policy.compressor_name != "blockmask":
        raise ValueError(
            f"the {meta.wire} wire ships PRNG-selected lane-blocks; a "
            f"compressing policy must use the 'blockmask' compressor, got "
            f"{policy.compressor_name!r}")
    if p2p and policy.compresses:
        for f_ in {meta.feat_dim, *meta.layer_dims}:
            if f_ % LANE:
                raise ValueError(
                    f"the p2p wire packs lane-blocks under a compressing "
                    f"policy, so every exchanged width must be divisible "
                    f"by {LANE}; got {f_}")
    # a static kept-block map wherever the payload's width follows the
    # rate: always on the packed wire, under compression on p2p
    needs_kb = packed_wire or (p2p and policy.compresses)

    def step(params, opt_state, graph, step_idx, key):
        rate = policy.rate(step_idx)
        kb = dict(_packed_k_for(meta, float(rate))) if needs_kb else None

        def loss_fn(p):
            if mesh is None:
                agg = _make_aggregate_emulated(graph, meta, policy, rate,
                                               key, packed_k=kb)
            else:
                agg = _make_aggregate_shard(graph, meta, policy, rate, key,
                                            mesh, packed_k=kb)
            return _local_loss_fn(p, cfg, graph, agg, meta)

        (loss, bits), grads = _value_and_grad(loss_fn, params)
        loss, new_params, new_state = _synced_update(
            opt, loss, grads, opt_state, params, mesh, sync)
        return new_params, new_state, _step_metrics(loss, rate, bits)

    return step


def make_eval_step(cfg: GNNConfig, meta: DistMeta,
                   mesh: WorkerMesh | None = None):
    """Full-communication accuracy over the train/val/test splits:
    ``evaluate(params, graph) -> {"train": acc, "val": acc, "test":
    acc}`` (float32 tensors), always over the dense wire; with a worker
    ``mesh`` each worker evaluates its block and the correct counts are
    all-reduced."""
    meta = dataclasses.replace(meta, wire="dense")
    splits = (("train", "train_mask", meta.n_train),
              ("val", "val_mask", meta.n_val),
              ("test", "test_mask", meta.n_test))

    def evaluate(params, graph):
        with torch.no_grad():
            one, key = torch.ones((), dtype=_F32), prng.key(0)
            if mesh is None:
                agg = _make_aggregate_emulated(graph, meta, FULL_COMM, one,
                                               key)
            else:
                agg = _make_aggregate_shard(graph, meta, FULL_COMM, one,
                                            key, mesh)
            logits, _ = gnn_forward(params, cfg, graph["features"], agg)
            pred = logits.argmax(-1)
            correct = torch.stack([((pred == graph["labels"]) *
                                    graph[mask_key].to(_F32)).sum()
                                   for _, mask_key, _ in splits])
            if mesh is not None:
                correct = mesh.all_reduce(correct)
            with span("sync.eval"):
                return {name: (correct[i] * _per(n)).cpu()
                        for i, (name, _, n) in enumerate(splits)}

    return evaluate


def make_infer_step(cfg: GNNConfig, policy, meta: DistMeta,
                    rounding: str = "rint"):
    """Inference-only distributed forward for the serving runtime.

    ``infer(params, graph, key, plan, cache=()) -> (logits, hiddens,
    metrics, cache')``: ``plan`` is a ``RatePlan`` (host ``[Q, Q]``
    rates, skip mask, optional widths), ``cache`` the per-exchange hop
    caches (``init_halo_cache`` shapes).  ``hiddens`` is every layer's
    post-activation output ``[Q, P, F_l]``; ``metrics`` (float32 CPU
    tensors) charges the wire one way: ``halo_bits``, ``transport_bits``,
    ``pair_transport``, ``pair_err`` and the per-exchange mean
    ``pair_delta``.  The plan's rates and widths are quantised to the
    static kept-block counts and storage widths on the host, as the JAX
    package does outside jit.  ``rounding="stochastic"`` rounds the
    quantised hops ``floor(v + u)`` under the per-(sender, hop)
    ``round_key`` stream, as in training.
    """
    if rounding not in ("rint", "stochastic"):
        raise ValueError(f"rounding must be 'rint' or 'stochastic', got "
                         f"{rounding!r}")
    if policy.mode != "auto":
        raise ValueError(f"make_infer_step needs an 'auto' policy, got "
                         f"mode {policy.mode!r}")
    if meta.wire != "p2p":
        raise ValueError("the serving forward reuses the hop caches; it "
                         f"needs wire='p2p', got {meta.wire!r}")
    for f_ in {meta.feat_dim, *meta.layer_dims}:
        if f_ % LANE:
            raise ValueError(
                f"per-pair rate maps pack lane-blocks; every exchanged "
                f"width must be divisible by {LANE}, got {f_}")
    reps = 1 if cfg.conv == "sage" else max(cfg.k_taps - 1, 1)
    n_ex = cfg.layers * reps
    q = meta.q

    def infer(params, graph, key, plan, cache=()):
        rm = np.asarray(plan.rates, np.float32)
        kb = _packed_pair_k_for(meta, rm)
        wm = ww = None
        if plan.widths is not None:
            wm = np.vectorize(_snap_width)(
                np.asarray(plan.widths, np.float32)).astype(np.float32)
            ww = _packed_pair_w_for(meta, wm)
        if not ww:
            wm = None
        cache = tuple(cache)
        cache_out: list = []
        hidden: list = []
        with torch.no_grad():
            agg = _make_aggregate_emulated(
                graph, meta, policy, torch.ones((), dtype=_F32), key,
                packed_k=dict(kb), rate_map=rm,
                skip=np.asarray(plan.skip, np.float32) if cache else None,
                cache=cache if cache else None,
                cache_out=cache_out if cache else None,
                width_map=wm, store_w=_packed_store_w(meta, wm),
                rounding=rounding)
            logits, bits = gnn_forward(params, cfg, graph["features"], agg,
                                       hidden_out=hidden)
        bits = bits.cpu()                 # the one device -> host sync
        n_layers = 1 if rm.ndim == 2 else rm.shape[0]
        lq2 = n_layers * q * q
        layer_t = bits[2:2 + lq2].reshape(n_layers, q, q)
        layer_e = bits[2 + lq2:2 + 2 * lq2].reshape(n_layers, q, q)
        layer_d = bits[2 + 2 * lq2:2 + 3 * lq2].reshape(n_layers, q, q)
        metrics = {"halo_bits": bits[0], "transport_bits": bits[1],
                   "pair_transport": layer_t.sum(0),
                   "pair_err": layer_e.sum(0),
                   "pair_delta": layer_d.sum(0) / max(n_ex, 1)}
        return logits, tuple(hidden), metrics, tuple(cache_out)

    return infer
