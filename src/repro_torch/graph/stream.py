"""Out-of-core streaming partition pipeline.

Numpy copy of ``repro.graph.stream``: the same on-disk formats, byte for
byte, so shard directories and stores written by either package load in
the other.  Only :meth:`ShardSet.device_arrays` differs — it returns torch
tensors on the requested device.

* **GraphStore** — an on-disk chunked-CSR graph: row-range edge chunks
  (``edges_*.npz``: rebased ``indptr`` + ``indices`` [+ ``wgt``]) and
  node-range payload chunks (``nodes_*.npz``: features / labels / split
  masks), with a ``store.json`` manifest.  Reading is a bounded-memory
  iterator; nothing ever holds the full edge or feature set.
* **spill_to_store** — the external bucket sort that turns arbitrary
  streamed ``(dst, src[, wgt])`` pairs into a canonical chunked CSR
  (symmetrised by the emitter, deduplicated / self-loop-dropped /
  row-sorted per bucket) — the construction path of the streaming
  synthetic generators (``repro_torch.graph.synthetic.stream_sbm_graph``
  / ``stream_powerlaw_graph``) and of each coarsening level's
  contraction.
* **stream_partition** — the multilevel partitioner: chunked
  leader/follower matching coarsens level by level (each coarse level is
  itself a weighted ``GraphStore``, spilled to disk until it fits), a
  weighted LDG + weighted ``refine_partition`` seeds the coarsest level,
  and uncoarsening projects owners down, re-refining at every level small
  enough to load.  Graphs that fit in core (``in_core_nodes``) take the
  exact reduction: the assembled CSR is bit-identical to the in-memory
  graph, so the owner vector equals ``partition_graph``'s for any chunk
  size.
* **write_shards / load_shards** — the on-disk per-worker shard format:
  one ``part_*.npz`` per partition holding that worker's rows of every
  runtime array (feature/label slabs, local + remote edge lists, publish
  lists, and the precomputed p2p halo / ELL indices of
  ``repro_torch.dist.halo``), plus a ``shards.json`` manifest carrying
  the serialised :class:`repro_torch.dist.halo.HaloSpec` and the global
  ``DistMeta`` facts, so a worker loads only its own partition and
  ``repro_torch.dist.gnn_parallel`` never touches the global graph.

Memory contract: O(num_nodes) per-node scalar arrays (owner, degrees,
local index) plus O(chunk) buffers and O(max partition) assembly slabs
are resident; the O(num_edges) structure and the O(n·F) features never
are.

Example::

    stream_sbm_graph(store_dir, n=1_000_000, feat_dim=128)
    store = open_store(store_dir)
    owner = stream_partition(store, q=16, scheme="metis-like")
    write_shards(store, owner, shard_dir)
    res = train_gnn(shard_dir, policy=CommPolicy.parse("fixed:4", 1),
                    wire="p2p")          # loads shards, never the graph
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from .data import GraphData
from .partition import PARTITIONERS, refine_partition

# default chunk granularity: ~64k rows / ~1M directed edges per chunk keeps
# per-chunk buffers in the tens of MB at any feature width
CHUNK_NODES = 65536
CHUNK_EDGES = 1 << 20

_STORE_MANIFEST = "store.json"
_SHARD_MANIFEST = "shards.json"


# ---------------------------------------------------------------------------
# GraphStore: chunked CSR + node payload on disk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphStore:
    """Manifest view of an on-disk chunked graph (see module docs).

    ``edge_rows[k] = (lo, hi)`` is edge chunk ``k``'s dst row range;
    ``indptr`` inside the chunk is rebased to 0.  ``has_nodes`` is False
    for coarse levels (contraction keeps structure only); ``weighted``
    marks per-edge ``wgt`` arrays (coarse multi-edge counts).
    """

    path: str
    num_nodes: int
    num_edges: int          # directed
    feat_dim: int
    num_classes: int
    name: str
    edge_rows: list
    node_rows: list
    has_nodes: bool = True
    weighted: bool = False

    def save_manifest(self) -> None:
        with open(os.path.join(self.path, _STORE_MANIFEST), "w") as fh:
            json.dump({k: getattr(self, k) for k in
                       ("num_nodes", "num_edges", "feat_dim", "num_classes",
                        "name", "edge_rows", "node_rows", "has_nodes",
                        "weighted")}, fh)

    def edge_chunks(self):
        """Yield ``(lo, hi, indptr, indices, wgt)`` per chunk; ``indptr``
        is rebased (``indptr[0] == 0``), ``wgt`` is None when unweighted."""
        for k, (lo, hi) in enumerate(self.edge_rows):
            with np.load(os.path.join(self.path, f"edges_{k:05d}.npz")) as z:
                yield (lo, hi, z["indptr"], z["indices"],
                       z["wgt"] if self.weighted else None)

    def node_chunks(self):
        """Yield ``(lo, hi, payload-dict)`` per node chunk."""
        for k, (lo, hi) in enumerate(self.node_rows):
            with np.load(os.path.join(self.path, f"nodes_{k:05d}.npz")) as z:
                yield lo, hi, {key: z[key] for key in z.files}

    def degrees(self) -> np.ndarray:
        """Streaming per-node degree (one pass over the indptr chunks)."""
        deg = np.zeros(self.num_nodes, np.int64)
        for lo, hi, indptr, _, _ in self.edge_chunks():
            deg[lo:hi] = np.diff(indptr)
        return deg


def open_store(path: str | os.PathLike) -> GraphStore:
    with open(os.path.join(path, _STORE_MANIFEST)) as fh:
        m = json.load(fh)
    return GraphStore(path=str(path),
                      edge_rows=[tuple(r) for r in m.pop("edge_rows")],
                      node_rows=[tuple(r) for r in m.pop("node_rows")], **m)


def is_store(path) -> bool:
    return isinstance(path, (str, os.PathLike)) and \
        os.path.exists(os.path.join(path, _STORE_MANIFEST))


def _row_chunks(n: int, indptr: np.ndarray | None, chunk_nodes: int,
                chunk_edges: int) -> list[tuple[int, int]]:
    """Row ranges capped at ``chunk_nodes`` rows / ``chunk_edges`` edges
    (rows never split; a single huge row gets its own chunk)."""
    rows = []
    lo = 0
    while lo < n:
        hi = min(lo + chunk_nodes, n)
        if indptr is not None:
            # largest hi with indptr[hi] - indptr[lo] <= chunk_edges
            cap = int(np.searchsorted(indptr, indptr[lo] + chunk_edges,
                                      side="right")) - 1
            hi = max(min(hi, cap), lo + 1)
        rows.append((lo, hi))
        lo = hi
    return rows or [(0, 0)]


def write_graph_store(g: GraphData, path: str | os.PathLike,
                      chunk_nodes: int = CHUNK_NODES,
                      chunk_edges: int = CHUNK_EDGES) -> GraphStore:
    """Chunk an in-memory ``GraphData`` to disk — the exact inverse of
    :func:`load_graph_store` (CSR round-trips bitwise for any chunk size,
    pinned by the tests)."""
    path = str(path)
    os.makedirs(path, exist_ok=True)
    store = GraphStore(
        path=path, num_nodes=g.num_nodes, num_edges=g.num_edges,
        feat_dim=g.feat_dim, num_classes=g.num_classes, name=g.name,
        edge_rows=_row_chunks(g.num_nodes, g.indptr, chunk_nodes,
                              chunk_edges),
        node_rows=_row_chunks(g.num_nodes, None, chunk_nodes, chunk_edges))
    for k, (lo, hi) in enumerate(store.edge_rows):
        e0, e1 = int(g.indptr[lo]), int(g.indptr[hi])
        np.savez(os.path.join(path, f"edges_{k:05d}.npz"),
                 indptr=(g.indptr[lo:hi + 1] - e0).astype(np.int64),
                 indices=g.indices[e0:e1].astype(np.int32))
    for k, (lo, hi) in enumerate(store.node_rows):
        np.savez(os.path.join(path, f"nodes_{k:05d}.npz"),
                 features=g.features[lo:hi], labels=g.labels[lo:hi],
                 train_mask=g.train_mask[lo:hi],
                 val_mask=g.val_mask[lo:hi], test_mask=g.test_mask[lo:hi])
    store.save_manifest()
    return store


def load_graph_store(store: GraphStore) -> GraphData:
    """Assemble the full ``GraphData`` — the in-core escape hatch for
    graphs that fit (the exact-reduction path of :func:`stream_partition`
    and the equivalence tests).  O(num_edges) memory by construction."""
    if not store.has_nodes:
        raise ValueError("store has no node payload (coarse level?)")
    indptr = np.zeros(store.num_nodes + 1, np.int64)
    idx_parts, base = [], 0
    for lo, hi, iptr, idx, _ in store.edge_chunks():
        indptr[lo + 1:hi + 1] = iptr[1:] + base
        base += int(iptr[-1])
        idx_parts.append(idx)
    payload = {k: [] for k in ("features", "labels", "train_mask",
                               "val_mask", "test_mask")}
    for _, _, chunk in store.node_chunks():
        for k in payload:
            payload[k].append(chunk[k])
    return GraphData(indptr=indptr,
                     indices=np.concatenate(idx_parts) if idx_parts
                     else np.zeros(0, np.int32),
                     **{k: np.concatenate(v) for k, v in payload.items()},
                     name=store.name)


# ---------------------------------------------------------------------------
# External bucket sort: streamed (dst, src[, wgt]) pairs -> chunked CSR
# ---------------------------------------------------------------------------


class EdgeSpill:
    """Bounded-memory edge accumulator: ``add`` buckets incoming directed
    pairs by dst row range onto disk; ``to_store`` sorts each bucket into
    canonical CSR rows (dedup + self-loop drop + ascending neighbours —
    the :func:`repro_torch.graph.data.from_edge_list` convention, applied one
    bucket at a time).  The emitter must send both directions of every
    undirected edge (symmetry is its contract, dedup is ours).
    """

    def __init__(self, n: int, workdir: str, bucket_nodes: int = CHUNK_NODES,
                 weighted: bool = False, drop_nonpositive: bool = False):
        self.n = n
        self.bucket_nodes = max(int(bucket_nodes), 1)
        self.n_buckets = max(-(-n // self.bucket_nodes), 1)
        self.weighted = weighted
        # signed-weight mode (streaming graph updates, serve/update.py):
        # inserts spill +1, deletes -1; duplicate summing nets them out and
        # edges whose total lands ≤ 0 are dropped from the canonical rows
        self.drop_nonpositive = drop_nonpositive
        if drop_nonpositive and not weighted:
            raise ValueError("drop_nonpositive sums signed weights; "
                             "it needs weighted=True")
        self.dir = workdir
        os.makedirs(workdir, exist_ok=True)
        self._piece = [0] * self.n_buckets

    def add(self, dst: np.ndarray, src: np.ndarray,
            wgt: np.ndarray | None = None) -> None:
        dst = np.asarray(dst, np.int64)
        src = np.asarray(src, np.int64)
        b = dst // self.bucket_nodes
        order = np.argsort(b, kind="stable")
        b_sorted = b[order]
        bounds = np.searchsorted(b_sorted, np.arange(self.n_buckets + 1))
        for bk in np.unique(b_sorted):
            sel = order[bounds[bk]:bounds[bk + 1]]
            cols = [dst[sel].astype(np.int32), src[sel].astype(np.int32)]
            if self.weighted:
                w = np.ones(len(sel), np.float64) if wgt is None \
                    else np.asarray(wgt, np.float64)[sel]
                cols.append(w)
            np.savez(os.path.join(
                self.dir, f"b{bk:05d}_{self._piece[bk]:05d}.npz"),
                dst=cols[0], src=cols[1],
                **({"wgt": cols[2]} if self.weighted else {}))
            self._piece[bk] += 1

    def _bucket_rows(self, bk: int):
        """Load + canonicalise one bucket: unique (dst, src) ascending,
        self-loops dropped, weights summed over duplicates."""
        ds, ss, ws = [], [], []
        for p in range(self._piece[bk]):
            with np.load(os.path.join(self.dir,
                                      f"b{bk:05d}_{p:05d}.npz")) as z:
                ds.append(z["dst"])
                ss.append(z["src"])
                if self.weighted:
                    ws.append(z["wgt"])
        if not ds:
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.float64) if self.weighted else None)
        dst = np.concatenate(ds).astype(np.int64)
        src = np.concatenate(ss).astype(np.int64)
        keep = dst != src
        dst, src = dst[keep], src[keep]
        key = dst * self.n + src
        if self.weighted:
            w = np.concatenate(ws)[keep]
            ukey, inv = np.unique(key, return_inverse=True)
            wsum = np.zeros(len(ukey), np.float64)
            np.add.at(wsum, inv, w)
            if self.drop_nonpositive:
                alive = wsum > 0.0
                ukey, wsum = ukey[alive], wsum[alive]
        else:
            ukey, wsum = np.unique(key), None
        return (ukey // self.n, (ukey % self.n).astype(np.int32), wsum)

    def canonical_edges(self) -> tuple[np.ndarray, np.ndarray,
                                       np.ndarray | None]:
        """Concatenated canonical directed rows over all buckets:
        ``(dst, src, wsum | None)``, dst-major ascending, self-loops
        dropped, duplicates summed (and, under ``drop_nonpositive``,
        netted-out edges removed).  The in-memory counterpart of
        :meth:`to_store` for graphs that fit (an edge-update batch
        rebuilds a :class:`repro_torch.graph.data.GraphData` from these
        rows)."""
        ds, ss, ws = [], [], []
        for bk in range(self.n_buckets):
            dst, src, wsum = self._bucket_rows(bk)
            ds.append(dst)
            ss.append(src)
            if self.weighted:
                ws.append(wsum)
        return (np.concatenate(ds), np.concatenate(ss),
                np.concatenate(ws) if self.weighted else None)

    def to_store(self, path: str | os.PathLike, *, name: str,
                 node_writer=None, feat_dim: int = 0, num_classes: int = 1,
                 chunk_nodes: int = CHUNK_NODES,
                 chunk_edges: int = CHUNK_EDGES) -> GraphStore:
        """Materialise the chunked-CSR store.  ``node_writer(lo, hi)``
        returns the payload dict for node rows ``[lo, hi)`` (None → a
        structure-only store, e.g. a coarse level)."""
        path = str(path)
        os.makedirs(path, exist_ok=True)
        edge_rows, num_edges, k_out = [], 0, 0
        for bk in range(self.n_buckets):
            b_lo = bk * self.bucket_nodes
            b_hi = min(b_lo + self.bucket_nodes, self.n)
            dst, src, wgt = self._bucket_rows(bk)
            w32 = wgt.astype(np.float32) if wgt is not None else None
            counts = np.bincount((dst - b_lo).astype(np.int64),
                                 minlength=b_hi - b_lo)
            iptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            # a bucket is at most bucket_nodes rows; split only on edges
            lo = b_lo
            while lo < b_hi:
                cap = int(np.searchsorted(iptr, iptr[lo - b_lo] + chunk_edges,
                                          side="right")) - 1
                hi = max(min(b_hi, b_lo + cap), lo + 1)
                e0, e1 = int(iptr[lo - b_lo]), int(iptr[hi - b_lo])
                np.savez(os.path.join(path, f"edges_{k_out:05d}.npz"),
                         indptr=(iptr[lo - b_lo:hi - b_lo + 1]
                                 - e0).astype(np.int64),
                         indices=src[e0:e1],
                         **({"wgt": w32[e0:e1]} if w32 is not None else {}))
                edge_rows.append((int(lo), int(hi)))
                num_edges += e1 - e0
                k_out += 1
                lo = hi
        node_rows = []
        if node_writer is not None:
            node_rows = _row_chunks(self.n, None, chunk_nodes, chunk_edges)
            for k, (lo, hi) in enumerate(node_rows):
                np.savez(os.path.join(path, f"nodes_{k:05d}.npz"),
                         **node_writer(lo, hi))
        store = GraphStore(path=path, num_nodes=self.n, num_edges=num_edges,
                           feat_dim=feat_dim, num_classes=num_classes,
                           name=name, edge_rows=edge_rows,
                           node_rows=node_rows,
                           has_nodes=node_writer is not None,
                           weighted=self.weighted)
        store.save_manifest()
        return store

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def spill_to_store(n: int, emit, path: str | os.PathLike, *, name: str,
                   node_writer=None, feat_dim: int = 0,
                   num_classes: int = 1, weighted: bool = False,
                   chunk_nodes: int = CHUNK_NODES,
                   chunk_edges: int = CHUNK_EDGES,
                   bucket_nodes: int | None = None) -> GraphStore:
    """Drive an edge emitter through the external sort into a store.

    ``emit(spill)`` calls ``spill.add(dst, src[, wgt])`` any number of
    times (both directions of every undirected edge); the result is the
    canonical chunked CSR.  The spill directory is temporary and removed.
    ``bucket_nodes`` sizes the sort buckets (default ``chunk_nodes``) —
    shrink it when the expected edges-per-node is high so the per-bucket
    dedup arrays stay bounded.
    """
    tmp = tempfile.mkdtemp(prefix="edge_spill_",
                           dir=os.path.dirname(str(path)) or ".")
    spill = EdgeSpill(n, tmp, bucket_nodes=bucket_nodes or chunk_nodes,
                      weighted=weighted)
    try:
        emit(spill)
        return spill.to_store(path, name=name, node_writer=node_writer,
                              feat_dim=feat_dim, num_classes=num_classes,
                              chunk_nodes=chunk_nodes,
                              chunk_edges=chunk_edges)
    finally:
        spill.cleanup()


# ---------------------------------------------------------------------------
# Multilevel streaming partitioner
# ---------------------------------------------------------------------------


def _hash_bit(ids: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic splitmix64-style bit per id (chunk-invariant)."""
    z = ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) \
        + np.uint64(2 * salt + 1)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return ((z ^ (z >> np.uint64(31))) & np.uint64(1)).astype(bool)


def _chunked_match(store: GraphStore, node_w: np.ndarray, max_w: float,
                   salt: int = 0) -> tuple[np.ndarray, int]:
    """One chunked leader/follower clustering round.

    A salted hash bit splits nodes into leaders and followers; each
    follower nominates its heaviest leader neighbour (ties → smallest
    id), and every leader accepts its nominees in ascending follower id
    while the merged weight stays under ``max_w``.  Unlike mutual-pair
    heavy-edge matching (which stalls once nominations stop being
    symmetric — a few % of nodes per round), roughly a third of the
    nodes collapse every round, so coarsening is geometric.  Returns
    ``(cluster [n] int64, n_coarse)`` with cluster ids compacted in
    ascending-representative order (deterministic, chunk-invariant:
    rows never split across chunks and acceptance is a global pass).
    """
    n = store.num_nodes
    leader = _hash_bit(np.arange(n, dtype=np.int64), salt)
    cand = np.full(n, -1, np.int64)
    for lo, hi, iptr, idx, wgt in store.edge_chunks():
        if len(idx) == 0:
            continue
        rows = np.repeat(np.arange(lo, hi, dtype=np.int64), np.diff(iptr))
        idx = idx.astype(np.int64)
        w = np.ones(len(idx), np.float64) if wgt is None \
            else wgt.astype(np.float64)
        sel = ~leader[rows] & leader[idx]     # follower -> leader edges
        rows, idx, w = rows[sel], idx[sel], w[sel]
        if not len(rows):
            continue
        # heaviest leader per follower, smallest id on ties: lexsort
        # keys (last key is primary) — row asc, weight desc, id asc
        order = np.lexsort((idx, -w, rows))
        first = np.unique(rows[order], return_index=True)[1]
        cand[rows[order][first]] = idx[order][first]
    rep = np.arange(n, dtype=np.int64)
    f = np.flatnonzero(cand >= 0)             # nominating followers
    if len(f):
        ld = cand[f]
        order = np.lexsort((f, ld))           # by leader, then follower
        f, ld = f[order], ld[order]
        wf = node_w[f]
        cum = np.cumsum(wf)
        starts = np.flatnonzero(np.concatenate([[True], ld[1:] != ld[:-1]]))
        run = np.repeat(starts, np.diff(np.concatenate([starts, [len(ld)]])))
        within = cum - (cum[run] - wf[run])   # cumulative within group
        ok = node_w[ld] + within <= max_w
        rep[f[ok]] = ld[ok]
    uniq, cluster = np.unique(rep, return_inverse=True)
    return cluster.astype(np.int64), len(uniq)


def _contract(store: GraphStore, cluster: np.ndarray, n_coarse: int,
              out_path: str) -> GraphStore:
    """Contract a level along ``cluster``: map both endpoints, drop
    intra-cluster edges, sum parallel edge weights (external sort)."""
    def emit(spill):
        for lo, hi, iptr, idx, wgt in store.edge_chunks():
            if len(idx) == 0:
                continue
            rows = np.repeat(np.arange(lo, hi, dtype=np.int64),
                             np.diff(iptr))
            cd, cs = cluster[rows], cluster[idx.astype(np.int64)]
            keep = cd != cs
            w = np.ones(len(idx), np.float64) if wgt is None \
                else wgt.astype(np.float64)
            spill.add(cd[keep], cs[keep], w[keep])

    # coarse levels have high edges-per-node: size buckets so each holds
    # ~chunk_edges pre-dedup pairs, keeping the sort transients bounded
    per_node = max(store.num_edges // max(n_coarse, 1), 1)
    bucket = min(CHUNK_NODES, max(CHUNK_EDGES // (2 * per_node), 4096))
    return spill_to_store(n_coarse, emit, out_path,
                          name=f"{store.name}-c", weighted=True,
                          bucket_nodes=bucket)


def _weighted_ldg(indptr, indices, ewgt, node_w, q: int, seed: int,
                  slack: float) -> np.ndarray:
    """Weighted linear deterministic greedy over a BFS order — the
    coarsest-level seeding of the multilevel partitioner (the weighted
    analogue of :func:`repro_torch.graph.partition.greedy_partition`)."""
    from collections import deque

    n = len(node_w)
    rng = np.random.default_rng(seed)
    capacity = slack * float(node_w.sum()) / q
    owner = np.full(n, -1, np.int32)
    sizes = np.zeros(q, np.float64)
    order = np.empty(n, np.int64)
    pos = 0
    visited = np.zeros(n, bool)
    for start in rng.permutation(n):
        if visited[start]:
            continue
        dq = deque([start])
        visited[start] = True
        while dq:
            u = dq.popleft()
            order[pos] = u
            pos += 1
            for v in indices[indptr[u]:indptr[u + 1]]:
                if not visited[v]:
                    visited[v] = True
                    dq.append(v)
    counts = np.zeros(q, np.float64)
    for u in order:
        counts[:] = 0.0
        sl = slice(indptr[u], indptr[u + 1])
        neigh = indices[sl]
        if len(neigh):
            owned = owner[neigh]
            ok = owned >= 0
            if ok.any():
                np.add.at(counts, owned[ok], ewgt[sl][ok])
        # strict feasibility: never place into a part the node overfills
        # (the argmin fallback fires only when every part is full, so
        # final imbalance is bounded by one node weight, not by drift)
        fits = sizes + node_w[u] <= capacity
        score = counts * np.maximum(1.0 - sizes / capacity, 0.0)
        if fits.any():
            score = np.where(fits, score, -1.0)
            best = int(np.argmax(score))
            if score[best] <= 0.0:
                masked = np.where(fits, sizes, np.inf)
                best = int(np.argmin(masked))
        else:
            best = int(np.argmin(sizes))
        owner[u] = best
        sizes[best] += node_w[u]
    return owner


def _rebalance(owner: np.ndarray, node_w: np.ndarray, q: int,
               slack: float) -> np.ndarray:
    """Move lightest nodes out of overfull parts until every part fits
    the weighted capacity (LDG's all-parts-full fallback can overshoot
    it).  Refinement never re-breaks the bound — its moves are
    capacity-gated — and uncoarsening projects weights exactly, so this
    single pass makes the final node balance ≤ slack."""
    owner = owner.copy()
    capacity = slack * float(node_w.sum()) / q
    sizes = np.bincount(owner, weights=node_w, minlength=q)
    for p in np.flatnonzero(sizes > capacity):
        nodes = np.flatnonzero(owner == p)
        nodes = nodes[np.argsort(node_w[nodes], kind="stable")]
        for u in nodes:
            if sizes[p] <= capacity:
                break
            t = int(np.argmin(sizes))
            if sizes[t] + node_w[u] > capacity:
                break               # nowhere to put it without overfilling
            owner[u] = t
            sizes[p] -= node_w[u]
            sizes[t] += node_w[u]
    return owner


def _level_graph(store: GraphStore) -> tuple:
    """Load one (small) level fully: ``(GraphData, edge weights | None)``.
    Coarse levels carry no node payload, so the GraphData gets dummy
    features/labels — the partitioners only read the CSR."""
    n = store.num_nodes
    indptr = np.zeros(n + 1, np.int64)
    idx_parts, w_parts, base = [], [], 0
    for lo, hi, iptr, idx, wgt in store.edge_chunks():
        indptr[lo + 1:hi + 1] = iptr[1:] + base
        base += int(iptr[-1])
        idx_parts.append(idx)
        if wgt is not None:
            w_parts.append(wgt)
    indices = np.concatenate(idx_parts) if idx_parts \
        else np.zeros(0, np.int32)
    ew = np.concatenate(w_parts).astype(np.float64) if w_parts else None
    dummy = np.zeros(n, np.int32)
    g = GraphData(indptr=indptr, indices=indices,
                  features=np.zeros((n, 1), np.float32), labels=dummy,
                  train_mask=np.zeros(n, bool), val_mask=np.zeros(n, bool),
                  test_mask=np.zeros(n, bool), name=store.name)
    return g, ew


def stream_partition(store: GraphStore, q: int, scheme: str = "metis-like",
                     seed: int = 0, slack: float = 1.05,
                     in_core_nodes: int = 200_000,
                     coarsen_target: int = 20_000,
                     refine_max_nodes: int = 150_000,
                     max_rounds: int = 20) -> np.ndarray:
    """Partition a :class:`GraphStore` into ``q`` parts without ever
    materialising the full graph.

    * ``scheme="random"`` — the paper's random assignment, O(n) memory.
    * graphs with ``num_nodes <= in_core_nodes`` — **exact reduction**:
      the chunked CSR is assembled (it is bit-identical to the source
      graph for any chunk size) and handed to the in-memory partitioner,
      so the owner vector equals ``partition_graph``'s exactly.
    * larger graphs — **multilevel**: chunked heavy-edge matching
      coarsens until ``coarsen_target`` nodes (every level an on-disk
      weighted store), weighted LDG + weighted
      :func:`repro_torch.graph.partition.refine_partition` seed the coarsest
      level, and uncoarsening projects owners down, re-refining with the
      same ``refine_partition`` at each level with at most
      ``refine_max_nodes`` nodes (levels above that project only — the
      coarse structure already carries the cut quality).

    Returns the ``[num_nodes]`` int32 owner vector.
    """
    n = store.num_nodes
    if scheme == "random":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        owner = np.empty(n, np.int32)
        for i in range(q):
            owner[perm[i::q]] = i
        return owner
    if scheme != "metis-like":
        raise ValueError(f"unknown scheme {scheme!r}; "
                         f"have ('random', 'metis-like')")

    if n <= in_core_nodes:
        g = load_graph_store(store) if store.has_nodes \
            else _level_graph(store)[0]
        return PARTITIONERS[scheme](g, q, seed=seed)

    # --- coarsen ---------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="mlevel_", dir=store.path)
    try:
        levels = [store]
        clusters = []
        node_w = np.ones(n, np.float64)
        weights = [node_w]
        # start the cluster-weight cap at ~3% of a part (placement stays
        # granular → balance), doubling it whenever matching stalls
        # (<10% reduction) up to a hard 12.5%-of-part cap — the METIS
        # adaptive-cap trick, so coarsening reaches the target at every
        # scale without giving up balance granularity early
        max_w = max(float(n) / (q * 32.0), 2.0)
        max_w_cap = max(float(n) / (q * 8.0), 2.0)
        cur = store
        for r in range(max_rounds):
            if cur.num_nodes <= coarsen_target:
                break
            cluster, n_coarse = _chunked_match(cur, weights[-1], max_w,
                                               salt=r)
            if n_coarse >= 0.90 * cur.num_nodes:
                if max_w >= max_w_cap:
                    break               # stalled at the hard cap
                max_w = min(2.0 * max_w, max_w_cap)
                continue
            cur = _contract(cur, cluster, n_coarse,
                            os.path.join(tmp, f"level_{r:02d}"))
            w_next = np.zeros(n_coarse, np.float64)
            np.add.at(w_next, cluster, weights[-1])
            clusters.append(cluster)
            weights.append(w_next)
            levels.append(cur)

        # --- initial partition at the coarsest level ---------------------
        g_c, ew_c = _level_graph(levels[-1])
        ew_c = ew_c if ew_c is not None else \
            np.ones(g_c.num_edges, np.float64)
        owner = _weighted_ldg(g_c.indptr, g_c.indices, ew_c, weights[-1],
                              q, seed, slack)
        owner = _rebalance(owner, weights[-1], q, slack)
        owner = refine_partition(g_c, owner, q, seed=seed, slack=slack,
                                 node_weight=weights[-1], edge_weight=ew_c)

        # --- uncoarsen + refine ------------------------------------------
        for li in range(len(clusters) - 1, -1, -1):
            owner = owner[clusters[li]]
            lvl = levels[li]
            if lvl.num_nodes <= refine_max_nodes:
                # finer levels carry smaller node weights, so the repair
                # that was infeasible around coarse boulder clusters
                # converges here; refine then only improves the cut
                # within the same capacity
                owner = _rebalance(owner, weights[li], q, slack)
                g_l, ew_l = _level_graph(lvl)
                owner = refine_partition(g_l, owner, q, seed=seed,
                                         slack=slack,
                                         node_weight=weights[li],
                                         edge_weight=ew_l)
        return owner.astype(np.int32)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def stream_edge_cut(store: GraphStore, owner: np.ndarray) -> dict:
    """Streaming edge-cut statistics of ``owner``: one pass
    over the edge chunks, O(chunk) memory."""
    n_cross = n_total = 0
    for lo, hi, iptr, idx, _ in store.edge_chunks():
        if len(idx) == 0:
            continue
        rows = np.repeat(np.arange(lo, hi, dtype=np.int64), np.diff(iptr))
        n_cross += int((owner[rows] != owner[idx]).sum())
        n_total += len(idx)
    return {"self_edges": n_total - n_cross, "cross_edges": n_cross,
            "self_frac": (n_total - n_cross) / max(n_total, 1),
            "cross_frac": n_cross / max(n_total, 1)}


# ---------------------------------------------------------------------------
# On-disk per-worker shards
# ---------------------------------------------------------------------------


def _local_index_of(store: GraphStore, owner: np.ndarray,
                    q: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-node index within its partition, ascending by global id —
    the same numbering ``build_partitioned`` assigns.  Chunked."""
    from repro_torch.dist.halo import _group_slots

    local_index = np.zeros(store.num_nodes, np.int32)
    base = np.zeros(q, np.int64)
    for lo, hi in store.node_rows or [(0, store.num_nodes)]:
        o = owner[lo:hi].astype(np.int64)
        order, slot_in, counts = _group_slots(o, q)
        li = np.empty(hi - lo, np.int64)
        li[order] = base[o[order]] + slot_in
        local_index[lo:hi] = li.astype(np.int32)
        base += counts[:q]
    return local_index, base            # base == per-partition sizes


def write_shards(store: GraphStore, owner: np.ndarray,
                 out_dir: str | os.PathLike, norm: str = "mean") -> str:
    """Write the per-worker shard set of ``store`` under ``owner``.

    Layout (all padding widths global, recorded in ``shards.json``):

    * ``part_{p:05d}.npz`` — partition ``p``'s rows of every runtime
      array: ``features [P, F]``, ``labels``/``*_mask``/``node_valid``
      ``[P]``, local + remote edge lists (``local_dst/src/w/w_iso
      [El]``, ``remote_dst/src/w [Er]``), publish lists (``send_idx/
      send_valid [B]``), and the precomputed p2p halo + ELL arrays of
      ``repro_torch.dist.halo`` (``p2p_send_slot/p2p_send_valid [D, H]``,
      ``remote_src_p2p [Er]``, ``ell_* [P, K]``).
    * ``shards.json`` — global facts (``part_size``, ``halo_size``,
      ``halo_demand``, split counts, …) plus the serialised
      :class:`repro_torch.dist.halo.HaloSpec`, so ``DistMeta`` builds without
      touching any shard, let alone the graph.
    * ``owner.npy`` — the global owner vector (provenance; loaders
      never read it).

    The arrays are bitwise-identical to
    ``build_partitioned(g, owner) → attach_p2p`` on the assembled graph
    (pinned by the tests), but construction is streaming: two edge-chunk
    passes into per-partition spill files, one node-chunk pass into
    per-partition slabs, then one partition assembled at a time.
    """
    from repro_torch.dist.halo import (HaloSpec, _group_slots,
                                       build_reverse_ell)

    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    n = store.num_nodes
    q = int(owner.max()) + 1 if len(owner) else 1
    owner = np.asarray(owner, np.int32)
    deg = np.maximum(store.degrees(), 1).astype(np.float32)
    local_index, part_counts = _local_index_of(store, owner, q)
    part_size = max(int(part_counts.max()), 1)

    # ---- edge pass 1: boundary flags + local degrees + per-part spills --
    tmp = tempfile.mkdtemp(prefix="shard_spill_", dir=out_dir)
    piece = [0] * q
    is_boundary = np.zeros(n, bool)
    local_deg = np.zeros(n, np.int64)
    cross_edges = 0
    try:
        for lo, hi, iptr, idx, _ in store.edge_chunks():
            if len(idx) == 0:
                continue
            rows = np.repeat(np.arange(lo, hi, dtype=np.int64),
                             np.diff(iptr))
            src = idx.astype(np.int64)
            is_local = owner[rows] == owner[src]
            is_boundary[src[~is_local]] = True
            np.add.at(local_deg, rows[is_local], 1)
            cross_edges += int((~is_local).sum())
            p_of = owner[rows]
            order = np.argsort(p_of, kind="stable")  # preserves CSR order
            po = p_of[order]
            bounds = np.searchsorted(po, np.arange(q + 1))
            for p in np.unique(po):
                sel = order[bounds[p]:bounds[p + 1]]
                np.savez(os.path.join(tmp, f"p{p:05d}_{piece[p]:05d}.npz"),
                         dstg=rows[sel].astype(np.int32),
                         srcg=src[sel].astype(np.int32),
                         loc=is_local[sel])
                piece[p] += 1

        # ---- publish (boundary) slots, ascending per partition ----------
        send_slot = np.full(n, -1, np.int32)
        send_counts = np.zeros(q, np.int64)
        for lo, hi in store.node_rows or [(0, n)]:
            b_sel = np.flatnonzero(is_boundary[lo:hi]) + lo
            o = owner[b_sel].astype(np.int64)
            order, slot_in, counts = _group_slots(o, q)
            send_slot[b_sel[order]] = \
                (send_counts[o[order]] + slot_in).astype(np.int32)
            send_counts += counts[:q]
        halo_size = max(int(send_counts.max()), 1)

        def _load_part_edges(p: int):
            cols = {"dstg": [], "srcg": [], "loc": []}
            for k in range(piece[p]):
                with np.load(os.path.join(tmp,
                                          f"p{p:05d}_{k:05d}.npz")) as z:
                    for c in cols:
                        cols[c].append(z[c])
            if not cols["dstg"]:
                return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, bool))
            return (np.concatenate(cols["dstg"]).astype(np.int64),
                    np.concatenate(cols["srcg"]).astype(np.int64),
                    np.concatenate(cols["loc"]))

        # ---- pass A over partitions: global padding widths + pair sets --
        el = er = ell_k = rev_k = 1
        halo_demand = 0
        pair_sets: list[list] = [[None] * q for _ in range(q)]
        for p in range(q):
            dstg, srcg, loc = _load_part_edges(p)
            el = max(el, int(loc.sum()))
            er = max(er, int((~loc).sum()))
            if loc.any():
                dl = local_index[dstg[loc]].astype(np.int64)
                sl = local_index[srcg[loc]].astype(np.int64)
                ell_k = max(ell_k, int(np.bincount(dl).max()))
                rev_k = max(rev_k, int(np.bincount(sl).max()))
            r_src = srcg[~loc]
            halo_demand += len(np.unique(r_src))
            so = owner[r_src].astype(np.int64)
            for j in np.unique(so):
                pair_sets[p][j] = np.unique(send_slot[r_src[so == j]])
        pair_rows = np.zeros((q, q), np.int64)
        for i in range(q):
            for j in range(q):
                if j != i and pair_sets[i][j] is not None:
                    pair_rows[i, j] = len(pair_sets[i][j])
        hop_w = max(int(pair_rows.max()), 1)
        d_hops = max(q - 1, 1)
        spec = HaloSpec(q=q, hop_width=hop_w,
                        compact_rows=max((q - 1) * hop_w, 1),
                        ell_degree=ell_k, rev_degree=rev_k,
                        pair_rows=tuple(int(v) for v in pair_rows.ravel()))

        # ---- node pass: per-partition payload slabs ---------------------
        mask_keys = ("train_mask", "val_mask", "test_mask", "node_valid")
        slab_dir = os.path.join(tmp, "slabs")
        os.makedirs(slab_dir, exist_ok=True)
        slab_info = {"features": (np.float32, (part_size, store.feat_dim)),
                     "labels": (np.int32, (part_size,)),
                     **{k: (bool, (part_size,)) for k in mask_keys}}

        def _slab(key, p, mode):
            path = os.path.join(slab_dir, f"{key}{p}.npy")
            if mode == "w+":
                dt, shape = slab_info[key]
                return np.lib.format.open_memmap(path, mode="w+",
                                                 dtype=dt, shape=shape)
            return np.lib.format.open_memmap(path, mode=mode)

        for p in range(q):
            for key in slab_info:          # sparse zero-filled files
                _slab(key, p, "w+")
        n_train = n_val = n_test = 0
        for lo, hi, chunk in store.node_chunks():
            o = owner[lo:hi]
            li = local_index[lo:hi]
            n_train += int(chunk["train_mask"].sum())
            n_val += int(chunk["val_mask"].sum())
            n_test += int(chunk["test_mask"].sum())
            for p in np.unique(o):
                sel = o == p
                # open → write → flush → unmap per chunk: dirty slab
                # pages never accumulate across the whole node pass, so
                # peak RSS stays O(chunk), not O(n·F)
                for key in slab_info:
                    m = _slab(key, p, "r+")
                    m[li[sel]] = True if key == "node_valid" \
                        else chunk[key][sel]
                    m.flush()
                    del m

        # ---- pass B: assemble + write one shard at a time ---------------
        for p in range(q):
            dstg, srcg, loc = _load_part_edges(p)
            w_all = _edge_w(deg, dstg, srcg, norm)
            wiso_all = _edge_w(np.maximum(local_deg, 1).astype(np.float32),
                               dstg, srcg, norm)
            d_loc = local_index[dstg[loc]]
            s_loc = local_index[srcg[loc]]
            shard = {
                "local_dst": _pad1(d_loc, el, part_size, np.int32),
                "local_src": _pad1(s_loc, el, 0, np.int32),
                "local_w": _pad1(w_all[loc], el, 0.0, np.float32),
                "local_w_iso": _pad1(wiso_all[loc], el, 0.0, np.float32),
            }
            r_dst = local_index[dstg[~loc]]
            r_src = srcg[~loc]
            flat = owner[r_src].astype(np.int64) * halo_size + \
                send_slot[r_src]
            shard["remote_dst"] = _pad1(r_dst, er, part_size, np.int32)
            shard["remote_src"] = _pad1(flat, er, 0, np.int32)
            shard["remote_w"] = _pad1(w_all[~loc], er, 0.0, np.float32)

            # publish list: this partition's boundary nodes, ascending
            mine_b = np.zeros(0, np.int64)
            for lo, hi in store.node_rows or [(0, n)]:
                sel = np.flatnonzero((owner[lo:hi] == p) &
                                     is_boundary[lo:hi]) + lo
                mine_b = np.concatenate([mine_b, sel])
            shard["send_idx"] = _pad1(local_index[mine_b], halo_size, 0,
                                      np.int32)
            shard["send_valid"] = _pad1(np.ones(len(mine_b)), halo_size,
                                        0.0, np.float32)

            # p2p halo rows (sender p: hop d -> receiver (p + d) mod q)
            p2p_slot = np.zeros((d_hops, hop_w), np.int32)
            p2p_valid = np.zeros((d_hops, hop_w), np.float32)
            for d in range(1, q):
                slots = pair_sets[(p + d) % q][p]
                if slots is not None and len(slots):
                    p2p_slot[d - 1, :len(slots)] = slots
                    p2p_valid[d - 1, :len(slots)] = 1.0
            shard["p2p_send_slot"] = p2p_slot
            shard["p2p_send_valid"] = p2p_valid
            rsp = np.zeros(er, np.int32)
            so = owner[r_src].astype(np.int64)
            for j in range(q):
                if j == p or pair_sets[p][j] is None:
                    continue
                sel = so == j
                if not sel.any():
                    continue
                pos = np.searchsorted(pair_sets[p][j],
                                      send_slot[r_src[sel]])
                rsp[:len(r_dst)][sel] = ((p - j) % q - 1) * hop_w + pos
            shard["remote_src_p2p"] = rsp

            # ELL lists (forward + reversed) for the local edges
            nbr = np.zeros((part_size, ell_k), np.int32)
            wf = np.zeros((part_size, ell_k), np.float32)
            wfi = np.zeros((part_size, ell_k), np.float32)
            valid = np.zeros((part_size, ell_k), bool)
            if loc.any():
                order, slot_in, _ = _group_slots(
                    d_loc.astype(np.int64), part_size)
                d_o = d_loc[order]
                nbr[d_o, slot_in] = s_loc[order]
                wf[d_o, slot_in] = w_all[loc][order]
                wfi[d_o, slot_in] = wiso_all[loc][order]
                valid[d_o, slot_in] = True
            rnbr, rslot = build_reverse_ell(nbr, valid, part_size,
                                            rev_k=rev_k)
            shard.update(ell_nbr=nbr, ell_w=wf, ell_w_iso=wfi,
                         ell_rnbr=rnbr, ell_rslot=rslot)

            for key in slab_info:
                m = _slab(key, p, "r")
                shard[key] = np.array(m)
                del m
            np.savez(os.path.join(out_dir, f"part_{p:05d}.npz"), **shard)

        np.save(os.path.join(out_dir, "owner.npy"), owner)
        meta = {"q": q, "part_size": part_size, "halo_size": halo_size,
                "num_nodes": n, "num_edges": store.num_edges,
                "feat_dim": store.feat_dim,
                "num_classes": store.num_classes,
                "halo_demand": int(halo_demand),
                "cross_edges": int(cross_edges),
                "n_train": n_train, "n_val": n_val, "n_test": n_test,
                "norm": norm, "name": store.name,
                "el": el, "er": er,
                "halo_spec": spec.to_dict()}
        with open(os.path.join(out_dir, _SHARD_MANIFEST), "w") as fh:
            json.dump(meta, fh)
        return out_dir
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _edge_w(deg: np.ndarray, dst: np.ndarray, src: np.ndarray,
            norm: str) -> np.ndarray:
    if norm == "mean":
        return (1.0 / deg[dst]).astype(np.float32)
    if norm == "sym":
        return (1.0 / np.sqrt(deg[dst] * deg[src])).astype(np.float32)
    raise ValueError(f"unknown normalisation {norm!r}")


def _pad1(vals, width: int, pad, dtype) -> np.ndarray:
    out = np.full(max(width, 1), pad, dtype)
    out[:len(vals)] = vals
    return out


# ---------------------------------------------------------------------------
# Shard loading
# ---------------------------------------------------------------------------

#: stacked-array keys every shard carries, in device_arrays() +
#: attach_p2p() order
_SHARD_KEYS = ("features", "labels", "train_mask", "val_mask", "test_mask",
               "node_valid", "local_dst", "local_src", "local_w",
               "local_w_iso", "remote_dst", "remote_src", "remote_w",
               "send_idx", "send_valid", "p2p_send_slot", "p2p_send_valid",
               "remote_src_p2p", "ell_nbr", "ell_w", "ell_w_iso",
               "ell_rnbr", "ell_rslot")


@dataclasses.dataclass
class ShardSet:
    """Loaded shard arrays + global facts — duck-types
    :class:`repro_torch.graph.partition.PartitionedGraph` for
    ``DistMeta.build`` and the aggregation oracles, with the
    :class:`repro_torch.dist.halo.HaloSpec` precomputed (``halo_spec``)
    so nothing recomputes the per-pair sets.

    ``parts`` records which partitions are loaded; a worker passes its own
    index to :func:`load_shards` and gets a ``[1, ...]`` stack holding
    only its slice (the shard_map per-worker block layout).
    """

    path: str
    q: int
    part_size: int
    halo_size: int
    num_nodes: int
    num_edges: int
    feat_dim: int
    num_classes: int
    halo_demand: int
    cross_edges: int
    n_train: int
    n_val: int
    n_test: int
    norm: str
    name: str
    halo_spec: object               # repro_torch.dist.halo.HaloSpec
    parts: tuple
    arrays: dict                    # key -> [len(parts), ...] numpy stack

    def __getattr__(self, key):
        arrays = object.__getattribute__(self, "arrays")
        if key in arrays:
            return arrays[key]
        raise AttributeError(key)

    def remote_pair_table(self):
        """Decode the flat halo indices per remote edge (the
        ``PartitionedGraph`` contract) — lets ``repro_torch.dist.halo`` rebuild
        the :class:`HaloSpec` from loaded shards, which the round-trip
        property pins bitwise against the manifest copy."""
        valid = self.remote_w > 0
        src_part = (self.remote_src // self.halo_size).astype(np.int32)
        slot = (self.remote_src % self.halo_size).astype(np.int32)
        return valid, src_part, slot

    def device_arrays(self, device="cuda") -> dict[str, torch.Tensor]:
        """The graph dict for the train step, as torch tensors on
        ``device``: the keys and dtypes of
        ``PartitionedGraph.device_arrays`` plus ``attach_p2p`` (shards
        carry the halo/ELL indices, so there is no attach step)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.arrays.items()}


def shard_meta(path: str | os.PathLike) -> dict:
    """The global shard facts without loading any shard (what a
    ``DistMeta`` needs — the 'never touch the global graph' contract)."""
    from repro_torch.dist.halo import HaloSpec

    with open(os.path.join(path, _SHARD_MANIFEST)) as fh:
        meta = json.load(fh)
    meta["halo_spec"] = HaloSpec.from_dict(meta["halo_spec"])
    return meta


def is_shard_dir(path) -> bool:
    return isinstance(path, (str, os.PathLike)) and \
        os.path.exists(os.path.join(path, _SHARD_MANIFEST))


def load_shards(path: str | os.PathLike,
                parts: list[int] | None = None) -> ShardSet:
    """Load shard arrays for ``parts`` (default: all) as ``[len(parts),
    ...]`` stacks.  A single-partition load reads exactly one
    ``part_*.npz`` — the per-worker ingestion path (and what the
    elastic-Q recovery uses to boot a replacement worker).  ``parts``
    must be unique, in-range partition ids; they are loaded in the
    given order."""
    meta = shard_meta(path)
    q = meta["q"]
    parts = list(range(q)) if parts is None else [int(p) for p in parts]
    if not parts:
        raise ValueError("parts must name at least one partition")
    if len(set(parts)) != len(parts):
        raise ValueError(f"duplicate partition ids in parts: {parts}")
    bad = [p for p in parts if not 0 <= p < q]
    if bad:
        raise ValueError(f"partition ids {bad} out of range for q={q}")
    stacks: dict[str, list] = {k: [] for k in _SHARD_KEYS}
    for p in parts:
        fname = os.path.join(path, f"part_{p:05d}.npz")
        if not os.path.exists(fname):
            raise FileNotFoundError(
                f"shard dir {path!s} is missing partition file "
                f"part_{p:05d}.npz (manifest says q={q})")
        with np.load(fname) as z:
            for k in _SHARD_KEYS:
                stacks[k].append(z[k])
    arrays = {k: np.stack(v) for k, v in stacks.items()}
    return ShardSet(path=str(path), parts=tuple(parts), arrays=arrays,
                    **{k: meta[k] for k in
                       ("q", "part_size", "halo_size", "num_nodes",
                        "num_edges", "feat_dim", "num_classes",
                        "halo_demand", "cross_edges", "n_train", "n_val",
                        "n_test", "norm", "name", "halo_spec")})
