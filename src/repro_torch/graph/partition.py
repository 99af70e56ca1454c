"""Graph partitioning + halo construction for partition-parallel serving.

Numpy copy of ``repro.graph.partition``: the same partitioners and the
same padded ``[Q, ...]`` layout, bitwise (tests/test_torch_graph.py pins
it).  Only :meth:`PartitionedGraph.device_arrays` differs — it returns
torch tensors on the requested device.

Partitioners
------------
* ``random_partition`` — the paper's random scheme.
* ``metis_like_partition`` — LDG streaming min-cut over a BFS order plus
  Kernighan-Lin-style refinement (the offline METIS stand-in).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from .data import GraphData, normalized_edge_weights


# ---------------------------------------------------------------------------
# Partitioners
# ---------------------------------------------------------------------------


def random_partition(g: GraphData, q: int, seed: int = 0) -> np.ndarray:
    """Equal-size random assignment (paper's random partitioning)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.num_nodes)
    owner = np.empty(g.num_nodes, np.int32)
    for i in range(q):
        owner[perm[i::q]] = i
    return owner


def _canonical_rows(g: GraphData, weight: np.ndarray | None = None):
    """Within-row ascending copy of the CSR (weights permuted alongside)."""
    indptr, indices = g.indptr, g.indices
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64),
                     np.diff(indptr))
    order = np.lexsort((indices, rows))
    return indptr, indices[order], None if weight is None else weight[order]


def greedy_partition(g: GraphData, q: int, seed: int = 0,
                     slack: float = 1.03) -> np.ndarray:
    """METIS-like streaming min-cut (LDG) over a BFS node order."""
    n = g.num_nodes
    rng = np.random.default_rng(seed)
    capacity = slack * n / q
    owner = np.full(n, -1, np.int32)
    sizes = np.zeros(q, np.float64)
    indptr, indices, _ = _canonical_rows(g)

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
    assert pos == n

    counts = np.zeros(q, np.float64)
    for u in order:
        counts[:] = 0.0
        neigh = indices[indptr[u]:indptr[u + 1]]
        if len(neigh):
            owned = owner[neigh]
            owned = owned[owned >= 0]
            if len(owned):
                np.add.at(counts, owned, 1.0)
        score = counts * np.maximum(1.0 - sizes / capacity, 0.0)
        best = int(np.argmax(score))
        if score[best] <= 0.0:  # no placed neighbours / all parts look full
            best = int(np.argmin(sizes))
        owner[u] = best
        sizes[best] += 1.0
    return owner


def refine_partition(g: GraphData, owner: np.ndarray, q: int,
                     passes: int = 4, slack: float = 1.05, seed: int = 0,
                     node_weight: np.ndarray | None = None,
                     edge_weight: np.ndarray | None = None) -> np.ndarray:
    """Kernighan-Lin-style local refinement: greedily move nodes to the
    partition holding most of their neighbours, subject to balance.

    ``node_weight``/``edge_weight`` (per node / per directed edge, in
    ``g.edge_list()`` order) weight the balance constraint and the
    neighbour affinity — the coarse levels of the multilevel streaming
    partitioner (``repro_torch.graph.stream``); ``None`` (the default)
    is the unweighted refinement."""
    n = g.num_nodes
    rng = np.random.default_rng(seed)
    owner = owner.copy()
    indptr, indices, ew = _canonical_rows(g, edge_weight)
    if node_weight is None:
        capacity = slack * n / q
        sizes = np.bincount(owner, minlength=q).astype(np.float64)
    else:
        node_weight = np.asarray(node_weight, np.float64)
        capacity = slack * float(node_weight.sum()) / q
        sizes = np.bincount(owner, weights=node_weight, minlength=q)
    counts = np.zeros(q, np.float64)
    for _ in range(passes):
        moved = 0
        for u in rng.permutation(n):
            row = slice(indptr[u], indptr[u + 1])
            neigh = indices[row]
            if len(neigh) == 0:
                continue
            counts[:] = 0.0
            np.add.at(counts, owner[neigh],
                      1.0 if ew is None else ew[row])
            cur = owner[u]
            cur_count = counts[cur]
            counts[sizes >= capacity] = -np.inf
            # staying put is always feasible; move only when strictly better
            counts[cur] = cur_count
            best = int(np.argmax(counts))
            if best != cur and counts[best] > counts[cur]:
                w_u = 1.0 if node_weight is None else node_weight[u]
                owner[u] = best
                sizes[cur] -= w_u
                sizes[best] += w_u
                moved += 1
        if moved == 0:
            break
    return owner


def metis_like_partition(g: GraphData, q: int, seed: int = 0,
                         slack: float = 1.03) -> np.ndarray:
    """LDG streaming + KL refinement — the offline METIS stand-in."""
    owner = greedy_partition(g, q, seed=seed, slack=slack)
    return refine_partition(g, owner, q, seed=seed)


PARTITIONERS = {"random": random_partition, "metis-like": metis_like_partition}


def edge_cut_stats(g: GraphData, owner: np.ndarray) -> dict:
    """Table-I statistics: self vs cross directed edge counts and
    fractions under the assignment ``owner``."""
    dst, src = g.edge_list()
    cross = owner[dst] != owner[src]
    n_cross = int(cross.sum())
    n_self = len(dst) - n_cross
    return {
        "self_edges": n_self,
        "cross_edges": n_cross,
        "self_frac": n_self / max(len(dst), 1),
        "cross_frac": n_cross / max(len(dst), 1),
    }


# ---------------------------------------------------------------------------
# Partitioned, padded device layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PartitionedGraph:
    """Padded ``[Q, ...]`` arrays for partition-parallel execution."""

    q: int
    part_size: int            # P: padded nodes per partition
    halo_size: int            # B: padded boundary (published) nodes per part
    num_nodes: int
    feat_dim: int
    num_classes: int
    halo_demand: int          # distinct (partition, remote node) pairs
    cross_edges: int

    owner: np.ndarray         # [n] partition of each global node
    local_index: np.ndarray   # [n] index of each global node in its partition

    features: np.ndarray      # [Q, P, F]
    labels: np.ndarray        # [Q, P] int32 (pad 0)
    train_mask: np.ndarray    # [Q, P] bool (pad False)
    val_mask: np.ndarray      # [Q, P] bool
    test_mask: np.ndarray     # [Q, P] bool
    node_valid: np.ndarray    # [Q, P] bool

    # local edges: dst/src are partition-local; pad dst -> P (dropped row)
    local_dst: np.ndarray     # [Q, El] int32
    local_src: np.ndarray     # [Q, El] int32
    local_w: np.ndarray       # [Q, El] f32 (global-degree normalisation)
    local_w_iso: np.ndarray   # [Q, El] f32 (local-degree norm; No-Comm mode)

    # remote edges: src indexes flattened halo buffer [Q*B]
    remote_dst: np.ndarray    # [Q, Er] int32 (pad -> P)
    remote_src: np.ndarray    # [Q, Er] int32 (pad -> 0)
    remote_w: np.ndarray      # [Q, Er] f32

    # publish list: local node indices each worker sends every layer
    send_idx: np.ndarray      # [Q, B] int32 (pad 0)
    send_valid: np.ndarray    # [Q, B] f32 (1 valid / 0 pad)

    def remote_pair_table(self):
        """Decode the flat ``remote_src`` halo indices per remote edge:
        ``(valid [Q, Er] bool, src_part [Q, Er] int32, slot [Q, Er]
        int32)`` — which peer partition and boundary slot each remote edge
        reads (padding rows have ``remote_w == 0``)."""
        valid = self.remote_w > 0
        src_part = (self.remote_src // self.halo_size).astype(np.int32)
        slot = (self.remote_src % self.halo_size).astype(np.int32)
        return valid, src_part, slot

    def device_arrays(self, device="cuda") -> dict[str, torch.Tensor]:
        """The graph dict handed to the distributed forward, as torch
        tensors on ``device`` (int32 indices, float32 weights, bool
        masks — the JAX package's dtypes)."""
        names = ("features", "labels", "train_mask", "val_mask",
                 "test_mask", "node_valid", "local_dst", "local_src",
                 "local_w", "local_w_iso", "remote_dst", "remote_src",
                 "remote_w", "send_idx", "send_valid")
        return {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k)))
                .to(device) for k in names}


def _pad_rows(rows: list[np.ndarray], pad_value, width: int | None = None,
              dtype=None) -> np.ndarray:
    width = max((len(r) for r in rows), default=1) if width is None else width
    width = max(width, 1)
    out = np.full((len(rows), width), pad_value,
                  dtype or np.asarray(rows[0]).dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def partition_graph(g: GraphData, q: int, scheme: str = "random",
                    norm: str = "mean", seed: int = 0) -> PartitionedGraph:
    """Partition ``g`` into ``q`` workers and build the padded halo layout."""
    owner = PARTITIONERS[scheme](g, q, seed=seed)
    return build_partitioned(g, owner, q, norm=norm)


def build_partitioned(g: GraphData, owner: np.ndarray, q: int,
                      norm: str = "mean") -> PartitionedGraph:
    n = g.num_nodes
    weights = normalized_edge_weights(g, kind=norm)
    dst, src = g.edge_list()
    e_owner_dst = owner[dst]
    e_owner_src = owner[src]
    is_local = e_owner_dst == e_owner_src

    # partition-local node numbering
    local_index = np.zeros(n, np.int32)
    part_nodes: list[np.ndarray] = []
    for p in range(q):
        nodes = np.flatnonzero(owner == p)
        local_index[nodes] = np.arange(len(nodes), dtype=np.int32)
        part_nodes.append(nodes)
    part_size = max(len(nodes) for nodes in part_nodes)

    # boundary (publish) sets: nodes with at least one cross out-edge.
    # undirected graph => a node needed remotely == has a cross edge.
    is_boundary = np.zeros(n, bool)
    cross_mask = ~is_local
    is_boundary[src[cross_mask]] = True
    send_rows, send_slot = [], np.full(n, -1, np.int32)
    for p in range(q):
        b_nodes = part_nodes[p][is_boundary[part_nodes[p]]]
        send_slot[b_nodes] = np.arange(len(b_nodes), dtype=np.int32)
        send_rows.append(local_index[b_nodes])
    halo_size = max((len(r) for r in send_rows), default=1)
    halo_size = max(halo_size, 1)

    # local-degree (isolated-subgraph) renormalisation for the No-Comm mode
    local_deg = np.zeros(n, np.int64)
    np.add.at(local_deg, dst[is_local], 1)
    if norm == "mean":
        w_iso_all = 1.0 / np.maximum(local_deg, 1).astype(np.float32)
        w_iso = w_iso_all[dst]
    else:  # sym
        d = np.maximum(local_deg, 1).astype(np.float32)
        w_iso = 1.0 / np.sqrt(d[dst] * d[src])

    local_dst_rows, local_src_rows, local_w_rows, local_wiso_rows = [], [], [], []
    remote_dst_rows, remote_src_rows, remote_w_rows = [], [], []
    demand = 0
    for p in range(q):
        mine = e_owner_dst == p
        loc = mine & is_local
        rem = mine & ~is_local
        local_dst_rows.append(local_index[dst[loc]])
        local_src_rows.append(local_index[src[loc]])
        local_w_rows.append(weights[loc].astype(np.float32))
        local_wiso_rows.append(w_iso[loc].astype(np.float32))
        r_src = src[rem]
        slot = send_slot[r_src]
        assert np.all(slot >= 0)
        flat = e_owner_src[rem].astype(np.int64) * halo_size + slot
        remote_dst_rows.append(local_index[dst[rem]])
        remote_src_rows.append(flat.astype(np.int32))
        remote_w_rows.append(weights[rem].astype(np.float32))
        demand += len(np.unique(r_src))

    def stack_nodes(values: np.ndarray, pad):
        out = np.full((q, part_size) + values.shape[1:], pad, values.dtype)
        for p in range(q):
            out[p, :len(part_nodes[p])] = values[part_nodes[p]]
        return out

    node_valid = np.zeros((q, part_size), bool)
    for p in range(q):
        node_valid[p, :len(part_nodes[p])] = True

    send_valid = np.zeros((q, halo_size), np.float32)
    for p in range(q):
        send_valid[p, :len(send_rows[p])] = 1.0

    cross_edges = int((~is_local).sum())
    return PartitionedGraph(
        q=q, part_size=part_size, halo_size=halo_size, num_nodes=n,
        feat_dim=g.feat_dim, num_classes=g.num_classes,
        halo_demand=demand, cross_edges=cross_edges,
        owner=owner, local_index=local_index,
        features=stack_nodes(g.features, 0.0),
        labels=stack_nodes(g.labels, 0),
        train_mask=stack_nodes(g.train_mask, False),
        val_mask=stack_nodes(g.val_mask, False),
        test_mask=stack_nodes(g.test_mask, False),
        node_valid=node_valid,
        local_dst=_pad_rows(local_dst_rows, part_size, dtype=np.int32),
        local_src=_pad_rows(local_src_rows, 0, dtype=np.int32),
        local_w=_pad_rows(local_w_rows, 0.0, dtype=np.float32),
        local_w_iso=_pad_rows(local_wiso_rows, 0.0, dtype=np.float32),
        remote_dst=_pad_rows(remote_dst_rows, part_size, dtype=np.int32),
        remote_src=_pad_rows(remote_src_rows, 0, dtype=np.int32),
        remote_w=_pad_rows(remote_w_rows, 0.0, dtype=np.float32),
        send_idx=_pad_rows(send_rows, 0, width=halo_size, dtype=np.int32),
        send_valid=send_valid,
    )
