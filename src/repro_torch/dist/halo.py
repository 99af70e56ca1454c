"""Per-pair halo specs + ELL neighbour lists for the p2p wire.

Numpy copy of ``repro.dist.halo`` (bitwise the same arrays for the same
partition).  Built on the host at partition time:

* **per-pair halo index sets** — for each ordered pair ``(i ← j)``, the
  sorted set of ``j``'s boundary slots that partition ``i``'s remote edges
  reference, laid out per ring offset ``d = (i - j) mod Q``;
* **the compacted ``remote_src`` remap** — each remote edge re-indexed
  into the receiver's concatenated per-hop buffer ``[(Q-1)·H, F]``;
* **degree-padded ELL neighbour lists** for the local edges — forward
  lists ``(nbr, w, w_iso)`` for the ``ell_spmm`` kernel plus the reversed
  lists ``(rnbr, rslot)`` the training backward will run over;
* **remote ELL lists** over the receiver's compact halo buffer
  (:func:`remote_ell`), derived on the device from the remote edge list
  and its compact remap where the p2p wire's remote aggregation first
  runs them through the same kernel.  They are neither attached nor
  stored in shard files.

:func:`attach_p2p` merges them, as torch tensors on the requested
device, into the graph dict consumed by ``repro_torch.dist.gnn_parallel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Static facts of a per-pair halo layout (all hashable).

    ``hop_width`` (``H``) is the padded row count of one ring hop;
    ``compact_rows`` is the receiver-side concatenated buffer height
    ``max((Q-1)·H, 1)``.  ``pair_rows[i*Q + j]`` counts the distinct rows
    ``j`` ships to ``i`` (zero on the diagonal); their sum equals
    ``halo_demand``.
    """

    q: int
    hop_width: int
    compact_rows: int
    ell_degree: int
    rev_degree: int
    pair_rows: tuple

    def pair_table(self) -> np.ndarray:
        """``[Q, Q]`` per-pair row counts (receiver × sender)."""
        return np.asarray(self.pair_rows, np.int64).reshape(self.q, self.q)

    def to_dict(self) -> dict:
        """JSON-ready form — the shard manifests
        (``repro_torch.graph.stream``) persist the spec so shard-backed
        runs never rebuild it from the global graph."""
        return {"q": self.q, "hop_width": self.hop_width,
                "compact_rows": self.compact_rows,
                "ell_degree": self.ell_degree,
                "rev_degree": self.rev_degree,
                "pair_rows": list(self.pair_rows)}

    @staticmethod
    def from_dict(d: dict) -> "HaloSpec":
        """Inverse of :meth:`to_dict` (round-trips exactly)."""
        return HaloSpec(q=int(d["q"]), hop_width=int(d["hop_width"]),
                        compact_rows=int(d["compact_rows"]),
                        ell_degree=int(d["ell_degree"]),
                        rev_degree=int(d["rev_degree"]),
                        pair_rows=tuple(int(v) for v in d["pair_rows"]))


def _pair_slot_sets(pg) -> list[list[np.ndarray]]:
    """``sets[i][j]``: sorted unique boundary slots of ``j`` that ``i``'s
    remote edges reference (``None`` on the diagonal).  Memoised on the
    ``PartitionedGraph`` instance."""
    cached = getattr(pg, "_pair_slot_cache", None)
    if cached is not None:
        return cached
    valid, src_part, slot = pg.remote_pair_table()
    sets: list[list[np.ndarray]] = []
    for i in range(pg.q):
        row = []
        for j in range(pg.q):
            if j == i:
                row.append(None)
                continue
            sel = valid[i] & (src_part[i] == j)
            row.append(np.unique(slot[i][sel]))
        sets.append(row)
    pg._pair_slot_cache = sets
    return sets


def build_halo_spec(pg) -> HaloSpec:
    """Static halo/ELL facts for ``DistMeta``."""
    sets = _pair_slot_sets(pg)
    pair_rows = np.zeros((pg.q, pg.q), np.int64)
    for i in range(pg.q):
        for j in range(pg.q):
            if j != i:
                pair_rows[i, j] = len(sets[i][j])
    hop_w = max(int(pair_rows.max()), 1)
    ell_k, rev_k = _ell_degrees(pg)
    return HaloSpec(q=pg.q, hop_width=hop_w,
                    compact_rows=max((pg.q - 1) * hop_w, 1),
                    ell_degree=ell_k, rev_degree=rev_k,
                    pair_rows=tuple(int(v) for v in pair_rows.ravel()))


def halo_arrays(pg, spec: HaloSpec | None = None) -> dict[str, np.ndarray]:
    """The p2p exchange indices (stacked ``[Q, ...]`` numpy arrays).

    * ``p2p_send_slot [Q, D, H]`` — boundary slots worker ``j`` ships at
      ring offset ``d`` (row ``d-1``) to worker ``(j+d) mod Q``;
    * ``p2p_send_valid [Q, D, H]`` — 1 for genuine rows, 0 for padding;
    * ``remote_src_p2p [Q, Er]`` — each remote edge's row in the
      receiver's compact buffer (pad edges → 0, their weight is 0).

    ``D = max(Q-1, 1)`` so the arrays stay well-formed for ``Q == 1``.
    """
    spec = spec or build_halo_spec(pg)
    q, hop_w = pg.q, spec.hop_width
    d_hops = max(q - 1, 1)
    sets = _pair_slot_sets(pg)

    send_slot = np.zeros((q, d_hops, hop_w), np.int32)
    send_valid = np.zeros((q, d_hops, hop_w), np.float32)
    for j in range(q):
        for d in range(1, q):
            slots = sets[(j + d) % q][j]
            send_slot[j, d - 1, :len(slots)] = slots
            send_valid[j, d - 1, :len(slots)] = 1.0

    valid, src_part, slot = pg.remote_pair_table()
    remote_src_p2p = np.zeros_like(pg.remote_src)
    for i in range(q):
        for j in range(q):
            if j == i:
                continue
            sel = valid[i] & (src_part[i] == j)
            if not sel.any():
                continue
            pos = np.searchsorted(sets[i][j], slot[i][sel])
            d = (i - j) % q
            remote_src_p2p[i][sel] = (d - 1) * hop_w + pos

    return {"p2p_send_slot": send_slot, "p2p_send_valid": send_valid,
            "remote_src_p2p": remote_src_p2p.astype(np.int32)}


# ---------------------------------------------------------------------------
# ELL construction (local edges)
# ---------------------------------------------------------------------------


def _ell_degrees(pg) -> tuple[int, int]:
    """(max local in-degree, max local out-degree) across partitions."""
    p_sz = pg.part_size
    ell_k = rev_k = 1
    for p in range(pg.q):
        ok = pg.local_dst[p] < p_sz
        if ok.any():
            ell_k = max(ell_k, int(np.bincount(
                pg.local_dst[p][ok], minlength=p_sz).max()))
            rev_k = max(rev_k, int(np.bincount(
                pg.local_src[p][ok], minlength=p_sz).max()))
    return ell_k, rev_k


def _group_slots(ids, minlength: int):
    """Stable grouping by id: ``(order, slot_in, counts)`` with
    ``ids[order]`` group-sorted (a group keeps its elements' order) and
    ``slot_in`` each sorted element's index within its group — the ELL
    slot-assignment rule, for the local lists (numpy, on the host) and the
    remote ones (torch, on the graph's device).  The results are of
    ``ids``' kind."""
    host = isinstance(ids, np.ndarray)
    t = torch.from_numpy(np.require(ids, requirements=["C", "W"])) \
        if host else ids
    sorted_ids, order = torch.sort(t, stable=True)
    sorted_ids = sorted_ids.long()
    counts = torch.bincount(sorted_ids, minlength=minlength)
    slot_in = torch.arange(len(t), device=t.device) - \
        (torch.cumsum(counts, 0) - counts)[sorted_ids]
    out = (order, slot_in, counts)
    return tuple(v.numpy() for v in out) if host else out


def _reverse_slots(src: torch.Tensor, dst: torch.Tensor, flat: torch.Tensor,
                   n_src: int, rev_k: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reversed lists of edges given in the order each source sums
    them: ``(rnbr [n_src, RK], rslot [n_src, RK])``, ``rnbr[s]`` the
    destinations of source ``s``'s edges and ``rslot[s]`` their flat
    forward slots ``flat`` (``-1`` pad); ``RK`` is ``rev_k`` or the largest
    out-degree (one host read)."""
    order, pos, counts = _group_slots(src, n_src)
    most = int(counts.max()) if counts.numel() else 0
    rk = rev_k or max(most, 1)
    if most > rk:
        raise ValueError(f"rev_k={rk} below the max reverse degree {most}")
    rnbr = torch.zeros((n_src, rk), dtype=torch.int32, device=src.device)
    rslot = torch.full((n_src, rk), -1, dtype=torch.int32, device=src.device)
    src_o = src[order].long()
    rnbr[src_o, pos] = dst[order].int()
    rslot[src_o, pos] = flat[order].int()
    return rnbr, rslot


def build_reverse_ell(nbr: np.ndarray, valid: np.ndarray, n_src: int,
                      rev_k: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Reversed ELL lists: ``(rnbr [n_src, RK], rslot [n_src, RK])`` —
    ``rnbr[s]`` lists the destination rows fed by source ``s`` and
    ``rslot[s]`` the flat ``i·K + k`` position of the matching forward
    weight (``-1`` pad)."""
    k = nbr.shape[1]
    d_idx, k_idx = np.nonzero(valid)
    rnbr, rslot = _reverse_slots(
        torch.from_numpy(nbr[d_idx, k_idx]), torch.from_numpy(d_idx),
        torch.from_numpy(d_idx * k + k_idx), n_src, rev_k)
    return rnbr.numpy(), rslot.numpy()


def ell_arrays(pg, spec: HaloSpec | None = None) -> dict[str, np.ndarray]:
    """Degree-padded ELL lists of every partition's local edges:
    ``ell_nbr/ell_w/ell_w_iso [Q, P, K]`` (pad entries carry weight 0 and
    point at row 0) and the reversed ``ell_rnbr/ell_rslot [Q, P, RK]``."""
    spec = spec or build_halo_spec(pg)
    q, p_sz = pg.q, pg.part_size
    k, rk = spec.ell_degree, spec.rev_degree
    ok = pg.local_dst < p_sz
    row = np.nonzero(ok)[0] * p_sz + pg.local_dst[ok]     # p·P + destination
    order, slot_in, _ = _group_slots(row, q * p_sz)
    row_o = row[order]
    nbr = np.zeros((q * p_sz, k), np.int32)
    w = np.zeros((q * p_sz, k), np.float32)
    w_iso = np.zeros((q * p_sz, k), np.float32)
    valid = np.zeros((q * p_sz, k), bool)
    nbr[row_o, slot_in] = pg.local_src[ok][order]
    w[row_o, slot_in] = pg.local_w[ok][order]
    w_iso[row_o, slot_in] = pg.local_w_iso[ok][order]
    valid[row_o, slot_in] = True
    # the reversed lists of every partition at once, each source's edges in
    # (destination, slot) order as build_reverse_ell lays them out
    r, kk = np.nonzero(valid)
    d_ = r % p_sz
    rnbr, rslot = _reverse_slots(torch.from_numpy(r - d_ + nbr[r, kk]),
                                 torch.from_numpy(d_),
                                 torch.from_numpy(d_ * k + kk), q * p_sz, rk)
    nbr, w, w_iso = (v.reshape(q, p_sz, k) for v in (nbr, w, w_iso))
    rnbr, rslot = (v.numpy().reshape(q, p_sz, rk) for v in (rnbr, rslot))
    return {"ell_nbr": nbr, "ell_w": w, "ell_w_iso": w_iso,
            "ell_rnbr": rnbr, "ell_rslot": rslot}


# ---------------------------------------------------------------------------
# ELL construction (remote edges, over the compact halo buffer)
# ---------------------------------------------------------------------------


#: each graph's remote ELL lists, derived on first use (by its
#: ``remote_src_p2p`` tensor, with the ``remote_dst``/``remote_w`` tensors
#: they were derived beside): only the p2p wire's aggregation reads them
_REMOTE_ELL = WeakIdKeyDictionary()


def remote_ell(graph: dict) -> dict[str, torch.Tensor]:
    """Destination-major ELL lists of a p2p graph dict's remote edges over
    each receiver's compact ``[C, F]`` halo buffer, derived on the graph's
    device from ``remote_dst``, ``remote_src_p2p`` and ``remote_w`` at the
    first call for those tensors and kept while they live:

    * ``remote_nbr``/``remote_ell_w [Q, P, Kr]`` — each destination's
      compact rows and weights, its edges in edge-list order (the stable
      grouping of :func:`_group_slots`);
    * ``remote_rnbr``/``remote_rslot [Q, C, RKr]`` — the reversed lists
      the compact buffer's cotangent runs over (:func:`_reverse_slots`, as
      :func:`build_reverse_ell` lays them out), each compact row's edges
      in edge-list order.

    Pad edges (``remote_w == 0``) are dropped: ``Kr``/``RKr`` are the
    largest real remote in- and out-degrees (at least 1), and pad slots
    point at row 0 with weight 0.  ``C = D·H`` comes from the hop layout
    (``p2p_send_slot [Q, D, H]``).  Two host reads (the two degrees).
    """
    dst, src, w = (graph[k] for k in ("remote_dst", "remote_src_p2p",
                                      "remote_w"))
    hit = _REMOTE_ELL.get(src)
    if hit is not None and hit[0] is dst and hit[1] is w:
        return hit[2]
    q, p_sz = graph["node_valid"].shape
    n_c = graph["p2p_send_slot"].shape[1] * graph["p2p_send_slot"].shape[2]
    dev = w.device
    real = w != 0
    part = torch.arange(q, device=dev)[:, None].expand_as(w)[real]
    d, s, wv = dst[real].long(), src[real].long(), w[real]
    key = part * p_sz + d
    order, slot, counts = _group_slots(key, q * p_sz)
    k = max(int(counts.max()), 1)
    nbr = torch.zeros((q * p_sz, k), dtype=torch.int32, device=dev)
    ew = torch.zeros((q * p_sz, k), dtype=w.dtype, device=dev)
    nbr[key[order], slot] = s[order].int()
    ew[key[order], slot] = wv[order]
    slot_of = torch.empty_like(d)            # each edge's forward slot
    slot_of[order] = slot
    rnbr, rslot = _reverse_slots(part * n_c + s, d, d * k + slot_of, q * n_c)
    lists = {"remote_nbr": nbr.reshape(q, p_sz, k),
             "remote_ell_w": ew.reshape(q, p_sz, k),
             "remote_rnbr": rnbr.reshape(q, n_c, -1),
             "remote_rslot": rslot.reshape(q, n_c, -1)}
    _REMOTE_ELL[src] = (dst, w, lists)
    return lists


def remote_ell_stats(graph: dict) -> dict:
    """The padding of a p2p graph dict's remote ELL lists
    (:func:`remote_ell`): ``Kr``, ``RKr`` and the fill (real remote edges
    over ``Q·P·Kr`` slots) — how much of the lists' length is padding the
    kernel walks over (one host read)."""
    lists = remote_ell(graph)
    q, p_sz, k = lists["remote_nbr"].shape
    real = int((lists["remote_ell_w"] != 0).sum())
    return {"remote_ell_degree": k,
            "remote_rev_degree": int(lists["remote_rnbr"].shape[-1]),
            "remote_ell_fill": real / max(q * p_sz * k, 1)}


def attach_p2p(graph: dict, pg, device="cuda",
               spec: HaloSpec | None = None) -> dict:
    """Merge the p2p halo + ELL arrays, as torch tensors on ``device``,
    into a graph dict.  Returns a new dict; the input is not mutated.

    Example::

        graph = attach_p2p(pg.device_arrays("cuda"), pg, "cuda")
    """
    spec = spec or build_halo_spec(pg)
    out = dict(graph)
    for k, v in {**halo_arrays(pg, spec), **ell_arrays(pg, spec)}.items():
        out[k] = torch.from_numpy(v).to(device)
    return out


def pair_query_mass(pair_rows: np.ndarray,
                    queries_per_part: np.ndarray) -> np.ndarray:
    """``[Q, Q]`` query mass for the ``qos`` controller: the receiver's
    query count times the pair's halo rows (every query against partition
    ``r`` re-reads all of ``r``'s inbound halo rows)."""
    rows = np.asarray(pair_rows, np.float32)
    qc = np.asarray(queries_per_part, np.float32)
    if qc.shape != (rows.shape[0],):
        raise ValueError(f"queries_per_part must be [Q]={rows.shape[0]}, "
                         f"got {qc.shape}")
    return qc[:, None] * rows
