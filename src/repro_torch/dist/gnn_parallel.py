"""Partition-parallel GNN forward over the p2p halo wire (paper Algorithm 1).

Counterpart of the serving-side part of ``repro/dist/gnn_parallel.py``.
All ``Q`` partitions live stacked as ``[Q, ...]`` tensors on one device —
the JAX package's emulated backend, with its ``vmap`` over partitions
written out as a leading batch dimension.  A layer's aggregation is

* a **local** ELL aggregation over edges whose endpoints are both owned
  (the ``ell_spmm`` kernel, one launch for all partitions), plus
* a **remote** scatter over cross edges whose source rows arrive through
  the p2p halo exchange: every sender packs its boundary block down to the
  kept 128-lane blocks (``varco_pack``), slices one hop buffer per ring
  offset out of the packed rows, and each receiver unpacks its hops
  (``varco_unpack``) into a compact halo buffer.

This module ports the **p2p rate-map branch** only: per-pair ``[Q, Q]``
rate and width maps from the closed-loop controllers, the drift-gated hop
cache (skipped pairs are served from ``cache`` at zero wire bits) and the
quantised hop paths (round-to-nearest-even).  The dense and packed all-gather wires, the
scalar-rate p2p branch, error-feedback residuals, stochastic rounding and
the fault channels belong to the training port (ROADMAP queue 1).

Mask indices and the per-pair bookkeeping (kept counts, column masks,
ledger rows) are tiny and computed on the host with the JAX package's
key stream (``repro_torch.prng``); the ``[Q, P, F]`` activations stay on
the device.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.ops import (WIRE_WIDTHS, dequant_bits,
                                     ell_aggregate, pack_bits,
                                     per_block_wire_bits, quant_levels,
                                     wire_pack, wire_quant, wire_unpack)
from repro_torch.kernels.varco_pack import LANE, worker_block_maps_pos
from repro_torch.nn.gnn import GNNConfig, gnn_forward

WIRES = ("p2p",)


# ---------------------------------------------------------------------------
# Static partition metadata
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistMeta:
    """Static (hashable) facts about a partitioning, shared by every
    forward: sizes, the paper's ``halo_demand`` unit (distinct (requesting
    partition, remote node) pairs), each layer's input width, and the p2p
    wire's hop width ``H``, compact-buffer height and ``[Q·Q]`` per-pair
    halo row counts (receiver-major, diagonal 0)."""

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
            raise NotImplementedError(
                f"wire {self.wire!r} is not ported yet (ROADMAP queue 1: "
                f"dense/packed wires); the port runs wire='p2p'")

    @staticmethod
    def build(pg, params: dict, wire: str = "p2p") -> "DistMeta":
        from repro_torch.dist.halo import build_halo_spec

        dims = []
        for layer in params["layers"]:
            if "self" in layer:                       # sage
                dims.append(int(layer["self"]["w"].shape[0]))
            else:                                     # poly taps
                dims.append(int(layer["taps"][0]["w"].shape[0]))
        spec = build_halo_spec(pg)
        return DistMeta(
            q=pg.q, part_size=pg.part_size, halo_size=pg.halo_size,
            num_nodes=pg.num_nodes, feat_dim=pg.feat_dim,
            num_classes=pg.num_classes, halo_demand=pg.halo_demand,
            cross_edges=pg.cross_edges,
            n_train=int(pg.train_mask.sum()), n_val=int(pg.val_mask.sum()),
            n_test=int(pg.test_mask.sum()),
            layer_dims=tuple(dims), wire=wire,
            p2p_hop_width=spec.hop_width, p2p_compact=spec.compact_rows,
            pair_rows=spec.pair_rows)

    def pair_table(self) -> np.ndarray:
        """``[Q, Q]`` per-pair halo row counts (receiver × sender)."""
        if not self.pair_rows:
            raise ValueError("DistMeta.pair_rows is empty — build the meta "
                             "via DistMeta.build(...)")
        return np.asarray(self.pair_rows, np.int64).reshape(self.q, self.q)


# ---------------------------------------------------------------------------
# Per-pair rate maps — host-side static facts
# ---------------------------------------------------------------------------


def _exchanged_nbs(meta: DistMeta) -> tuple:
    """Sorted distinct lane-block counts of every exchanged width."""
    return tuple(sorted({d // LANE for d in (meta.feat_dim,
                                             *meta.layer_dims)}))


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
    jj_t = torch.as_tensor(np.broadcast_to(jj, rv.shape).copy(),
                           device=vals_jd.device)
    out[torch.as_tensor(rv, device=vals_jd.device), jj_t] = vals_jd
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
    return torch.cat([host.to(dev), embed(pair_err.to(f32)),
                      embed(pair_delta.to(f32))])


# ---------------------------------------------------------------------------
# The p2p rate-map aggregation oracle
# ---------------------------------------------------------------------------


def _make_aggregate_emulated(graph: dict, meta: DistMeta, key,
                             packed_k: dict | None, rate_map,
                             skip=None, cache=None,
                             cache_out: list | None = None,
                             width_map=None, store_w: int = 0):
    """AggregateFn over stacked ``[Q, P, F]`` tensors on one device — the
    JAX package's ``_make_aggregate_emulated`` on the p2p wire with a
    per-pair rate map.

    ``key`` is the refresh's raw key (``repro_torch.prng``); exchange
    ``call`` draws worker ``i``'s kept blocks from ``fold_in(fold_in(key,
    call), i)``.  ``rate_map`` (host ``[Q, Q]`` or ``[L, Q, Q]``) sets each
    pair's kept count under the static maximum ``packed_k``; ``width_map``
    quantises each pair's hop at its width (``store_w`` > 0: true sub-byte
    bytes rebuilt as ``levels · scale``).  ``skip``/``cache``/``cache_out``
    are the drift-gated hop reuse: a pair with ``skip[i, j] == 1`` is served
    ``cache[call]``'s rows at zero wire bits, and the fresh hop buffers
    (``[Q, D, H, F]`` per exchange) land in ``cache_out``.  Rounding is
    round-to-nearest-even (the JAX package's ``rounding="rint"``).

    The oracle carries the split-phase API: ``start(li, x) -> (token,
    bits)`` packs and ships, ``complete(li, x, token)`` runs the local ELL
    aggregation and folds in the delivered halo.
    """
    if meta.wire != "p2p":
        raise NotImplementedError("only the p2p wire is ported")
    if rate_map is None:
        raise NotImplementedError(
            "the scalar-rate p2p branch is not ported yet (ROADMAP queue 1:"
            " training slice); pass a [Q, Q] rate map")
    if store_w and width_map is None:
        raise ValueError("store_w (sub-byte storage) rides the width map; "
                         "pass width_map alongside it")
    if width_map is not None:
        _rate_tensor_layers(meta, width_map)
    q, p_sz = meta.q, meta.part_size
    n_layers = _rate_tensor_layers(meta, rate_map)
    rate_map = np.asarray(rate_map, np.float32)
    width_map = None if width_map is None else \
        np.asarray(width_map, np.float32)
    skip = None if skip is None else np.asarray(skip, np.float32)
    dev = graph["features"].device
    jj, rv = _ring_targets(q)
    d_hops = rv.shape[1]
    calls = itertools.count()

    def to_dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def start(li, x):                                  # x: [Q, P, F]
        """Issue layer ``li``'s exchange: pack, mask, ship.  Returns
        ``(compact halo [Q, C, F], ledger vector)``."""
        call = next(calls)
        f = x.shape[-1]
        rm = rate_map if rate_map.ndim == 2 else rate_map[li]
        lix = 0 if n_layers == 1 else li
        wm = None
        if width_map is not None:
            wm = width_map if width_map.ndim == 2 else width_map[li]

        # boundary block [Q, B, F]; packed once per sender, the hop buffers
        # are sliced out of the packed rows
        publish = _rows_of(x, graph["send_idx"], p_sz) * \
            graph["send_valid"][..., None]
        nb = f // LANE
        n_keep = packed_k[nb]
        k_call = prng.fold_in(key, call)
        kept, inv, pos_all = worker_block_maps_pos(k_call, q, nb, n_keep)
        pos_kept = np.take_along_axis(pos_all, kept, axis=1)     # [Q, K]
        k_pairs = _pair_keep(nb, rm, n_keep)                     # [Q, Q]
        k_jd = k_pairs[rv, jj]                                   # [Q, D]
        packed = wire_pack(publish.contiguous(), to_dev(kept))
        b_sz = publish.shape[1]
        hops = _rows_of(packed, graph["p2p_send_slot"], b_sz) * \
            graph["p2p_send_valid"][..., None]      # [Q, D, H, K·128]
        cmask = (pos_kept[:, None, :] < k_jd[..., None]).astype(np.float32)
        cmask_l = to_dev(np.repeat(cmask, LANE, axis=-1)[:, :, None, :])
        hops = hops * cmask_l
        if wm is not None:
            w_jd = to_dev(wm[rv, jj][:, :, None, None])          # [Q, D, 1, 1]
            if store_w:
                # sub-byte wire: the hop stack that would ride the wire is
                # the bit-packed levels + fp32 scales; the delivered values
                # are rebuilt from those bytes alone
                levels, scales = quant_levels(hops, w_jd)
                hops = dequant_bits(pack_bits(levels, store_w), scales,
                                    store_w)
            else:
                hops = wire_quant(hops, w_jd)
        h_w = hops.shape[2]
        sent = wire_unpack(hops.reshape(q, d_hops * h_w, -1).contiguous(),
                           to_dev(inv)).reshape(q, d_hops, h_w, f)
        pair_err = _scatter_pairs(
            (_pair_hop_energy(publish, graph["p2p_send_slot"],
                              graph["p2p_send_valid"]) *
             to_dev(pos_all[:, None, :] >= k_jd[:, :, None],
                    torch.float32)).sum(-1), q)
        pair_delta = torch.zeros((q, q), dtype=torch.float32, device=dev)
        live = None
        if cache is not None:
            c = cache[call]
            num = ((sent - c) ** 2).sum(dim=(-1, -2))
            den = (sent ** 2).sum(dim=(-1, -2)) + 1e-12
            pair_delta = _scatter_pairs(num / den, q)
            sk = skip[rv, jj]                                    # [Q, D]
            if sk.any():
                sent = torch.where(to_dev(sk[..., None, None] > 0.0), c,
                                   sent)
            live = 1.0 - skip
        if cache_out is not None:
            cache_out.append(sent)
        row_bits = k_pairs.astype(np.float32) * (
            per_block_wire_bits(wm).numpy() if wm is not None
            else np.float32(LANE * 32.0))
        bits = _pair_ledger(meta, f, rm, row_bits, pair_err, pair_delta,
                            live=live, li=lix, n_layers=n_layers,
                            width_map=wm)
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
        """Consume layer ``li``'s delivered halo: the local ELL
        aggregation plus the remote scatter out of the compact buffer."""
        del li
        f = x.shape[-1]
        loc = ell_aggregate(x.contiguous(), graph["ell_nbr"], graph["ell_w"])
        vals = graph["remote_w"][..., None] * \
            _rows_of(token, graph["remote_src_p2p"], token.shape[1])
        off = (torch.arange(q, device=dev) * (p_sz + 1))[:, None]
        rem = torch.zeros((q * (p_sz + 1), f), dtype=x.dtype, device=dev)
        rem.index_add_(0, (graph["remote_dst"].long() + off).reshape(-1),
                       vals.reshape(-1, f))
        return loc + rem.reshape(q, p_sz + 1, f)[:, :p_sz]

    def aggregate(li, x):
        token, bits = start(li, x)
        return complete(li, x, token), bits

    aggregate.start = start
    aggregate.complete = complete
    return aggregate


def make_infer_step(cfg: GNNConfig, policy, meta: DistMeta):
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
    package does outside jit.
    """
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
        agg = _make_aggregate_emulated(
            graph, meta, key, packed_k=dict(kb), rate_map=rm,
            skip=np.asarray(plan.skip, np.float32) if cache else None,
            cache=cache if cache else None,
            cache_out=cache_out if cache else None,
            width_map=wm, store_w=_packed_store_w(meta, wm))
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
