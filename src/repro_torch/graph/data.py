"""Graph containers: CSR graphs with node features/labels/splits.

Numpy copy of ``repro.graph.data`` (host-side preprocessing data; the
partitioner lowers it to padded ``[Q, ...]`` arrays and torch tensors).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphData:
    """An undirected graph in CSR form with node features and labels.

    ``indptr``/``indices`` encode, for each destination node ``i``, the
    source neighbours ``indices[indptr[i]:indptr[i+1]]`` (symmetric for
    undirected graphs).  Self-loops are not stored; convolutions add the
    self term explicitly.
    """

    indptr: np.ndarray      # [n+1] int64
    indices: np.ndarray     # [num_edges] int32 (directed edge count)
    features: np.ndarray    # [n, F] float32
    labels: np.ndarray      # [n] int32
    train_mask: np.ndarray  # [n] bool
    val_mask: np.ndarray    # [n] bool
    test_mask: np.ndarray   # [n] bool
    name: str = "graph"

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        """Directed edge count (2x undirected)."""
        return len(self.indices)

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        """(dst, src) arrays of all directed edges."""
        dst = np.repeat(np.arange(self.num_nodes, dtype=np.int32),
                        np.diff(self.indptr))
        return dst, self.indices.astype(np.int32)

    def validate(self) -> None:
        n = self.num_nodes
        checks = [
            self.indptr[0] == 0 and self.indptr[-1] == len(self.indices),
            np.all(np.diff(self.indptr) >= 0),
            self.indices.min(initial=0) >= 0,
            self.indices.max(initial=-1) < n,
            self.features.shape[0] == n,
            self.labels.shape == (n,),
        ]
        for m in (self.train_mask, self.val_mask, self.test_mask):
            checks.append(m.shape == (n,) and m.dtype == bool)
        # splits disjoint
        checks += [not np.any(self.train_mask & self.val_mask),
                   not np.any(self.train_mask & self.test_mask),
                   not np.any(self.val_mask & self.test_mask)]
        if not all(checks):
            raise ValueError(f"malformed GraphData {self.name!r}")


def from_edge_list(n: int, dst: np.ndarray, src: np.ndarray,
                   features: np.ndarray, labels: np.ndarray,
                   splits=(0.6, 0.2, 0.2), seed: int = 0,
                   name: str = "graph") -> GraphData:
    """Build a symmetric CSR GraphData from a directed edge list.

    The edge list is symmetrised and deduplicated; self-loops dropped.
    """
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    keep = dst != src
    dst, src = dst[keep], src[keep]
    # symmetrise + dedup via a packed key
    a = np.concatenate([dst, src])
    b = np.concatenate([src, dst])
    key = np.unique(a * n + b)
    a = (key // n).astype(np.int64)
    b = (key % n).astype(np.int32)
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, a + 1, 1)
    indptr = np.cumsum(indptr)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(splits[0] * n)
    n_val = int(splits[1] * n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train:n_train + n_val]] = True
    test_mask[perm[n_train + n_val:]] = True
    g = GraphData(indptr, b, np.asarray(features, np.float32),
                  np.asarray(labels, np.int32), train_mask, val_mask,
                  test_mask, name=name)
    g.validate()
    return g


def normalized_edge_weights(g: GraphData, kind: str = "mean") -> np.ndarray:
    """Per-directed-edge weights for the aggregation.

    ``mean``: 1/deg(dst)  (GraphSAGE mean aggregator)
    ``sym``:  1/sqrt(deg(dst) deg(src))  (GCN normalisation)
    """
    deg = np.maximum(g.degrees(), 1).astype(np.float32)
    dst, src = g.edge_list()
    if kind == "mean":
        return 1.0 / deg[dst]
    if kind == "sym":
        return 1.0 / np.sqrt(deg[dst] * deg[src])
    raise ValueError(f"unknown normalisation {kind!r}")
