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
  lists ``(rnbr, rslot)`` the training backward will run over.

:func:`attach_p2p` merges them, as torch tensors on the requested
device, into the graph dict consumed by ``repro_torch.dist.gnn_parallel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def _group_slots(ids: np.ndarray, minlength: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable grouping by id: ``(order, slot_in, counts)`` with
    ``ids[order]`` group-sorted and ``slot_in`` each element's index within
    its group — the ELL slot-assignment rule."""
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    counts = np.bincount(sorted_ids, minlength=minlength)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_in = np.arange(len(sorted_ids)) - starts[sorted_ids]
    return order, slot_in, counts


def build_reverse_ell(nbr: np.ndarray, valid: np.ndarray, n_src: int,
                      rev_k: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Reversed ELL lists: ``(rnbr [n_src, RK], rslot [n_src, RK])`` —
    ``rnbr[s]`` lists the destination rows fed by source ``s`` and
    ``rslot[s]`` the flat ``i·K + k`` position of the matching forward
    weight (``-1`` pad)."""
    n, k = nbr.shape
    d_idx, k_idx = np.nonzero(valid)
    src = nbr[d_idx, k_idx]
    order, pos, counts = _group_slots(src, n_src)
    src_o, d_o = src[order], d_idx[order]
    flat_o = (d_idx * k + k_idx)[order]
    rk = rev_k or max(int(counts.max(initial=0)), 1)
    if counts.max(initial=0) > rk:
        raise ValueError(f"rev_k={rk} below the max reverse degree "
                         f"{int(counts.max())}")
    rnbr = np.zeros((n_src, rk), np.int32)
    rslot = np.full((n_src, rk), -1, np.int32)
    rnbr[src_o, pos] = d_o
    rslot[src_o, pos] = flat_o
    return rnbr, rslot


def ell_arrays(pg, spec: HaloSpec | None = None) -> dict[str, np.ndarray]:
    """Degree-padded ELL lists of every partition's local edges:
    ``ell_nbr/ell_w/ell_w_iso [Q, P, K]`` (pad entries carry weight 0 and
    point at row 0) and the reversed ``ell_rnbr/ell_rslot [Q, P, RK]``."""
    spec = spec or build_halo_spec(pg)
    q, p_sz = pg.q, pg.part_size
    k, rk = spec.ell_degree, spec.rev_degree
    nbr = np.zeros((q, p_sz, k), np.int32)
    w = np.zeros((q, p_sz, k), np.float32)
    w_iso = np.zeros((q, p_sz, k), np.float32)
    rnbr = np.zeros((q, p_sz, rk), np.int32)
    rslot = np.full((q, p_sz, rk), -1, np.int32)
    for p in range(q):
        ok = pg.local_dst[p] < p_sz
        d_ = pg.local_dst[p][ok]
        order, slot_in, _ = _group_slots(d_, p_sz)
        d_o = d_[order]
        nbr[p, d_o, slot_in] = pg.local_src[p][ok][order]
        w[p, d_o, slot_in] = pg.local_w[p][ok][order]
        w_iso[p, d_o, slot_in] = pg.local_w_iso[p][ok][order]
        valid = np.zeros((p_sz, k), bool)
        valid[d_o, slot_in] = True
        rnbr[p], rslot[p] = build_reverse_ell(nbr[p], valid, p_sz, rev_k=rk)
    return {"ell_nbr": nbr, "ell_w": w, "ell_w_iso": w_iso,
            "ell_rnbr": rnbr, "ell_rslot": rslot}


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
