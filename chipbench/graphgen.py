"""The benchmark's graph generator: a frozen copy of the port's
``citation_graph`` (``repro_torch/graph/synthetic.py``) and of the CSR
constructor it calls (``from_edge_list`` in ``repro_torch/graph/data.py``).

The graph is the cells' traffic, so it lives here: a later change to the
program's generator cannot move the yardstick.  Plain numpy; the same
seed gives the same arrays as the program's copy at the time it was taken
(``tests/test_chipbench_harness.py`` holds them equal).

The generator is an SBM whose blocks are the classes (``homophily`` of
the edge mass stays inside a class) with noisy class-centroid features,
row-normalised, and a random train / validation / test split.
"""

from __future__ import annotations

import numpy as np


def _sbm_edges(rng, labels, n_classes, avg_deg_in, avg_deg_out):
    n = len(labels)
    class_nodes = [np.flatnonzero(labels == c) for c in range(n_classes)]
    sizes = np.array([len(c) for c in class_nodes], np.float64)
    dsts, srcs = [], []
    for ci in range(n_classes):
        ni = sizes[ci]
        if ni < 2:
            continue
        m_in = rng.poisson(ni * avg_deg_in / 2.0)
        if m_in:
            dsts.append(rng.choice(class_nodes[ci], m_in))
            srcs.append(rng.choice(class_nodes[ci], m_in))
        m_out = rng.poisson(ni * avg_deg_out / 2.0)
        if m_out:
            dsts.append(rng.choice(class_nodes[ci], m_out))
            srcs.append(rng.integers(0, n, m_out))
    return np.concatenate(dsts), np.concatenate(srcs)


def _features(rng, labels, n_classes, dim, signal):
    centroids = rng.normal(0.0, 1.0, (n_classes, dim)).astype(np.float32)
    noise = rng.normal(0.0, 1.0, (len(labels), dim)).astype(np.float32)
    feats = signal * centroids[labels] + noise
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-6
    return feats


def _csr(n, dst, src, features, labels, splits, seed) -> dict:
    """Symmetrised, deduplicated CSR without self-loops, and the split."""
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    keep = dst != src
    dst, src = dst[keep], src[keep]
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
    masks = {name: np.zeros(n, bool) for name in ("train", "val", "test")}
    masks["train"][perm[:n_train]] = True
    masks["val"][perm[n_train:n_train + n_val]] = True
    masks["test"][perm[n_train + n_val:]] = True
    return {"indptr": indptr, "indices": b,
            "features": np.asarray(features, np.float32),
            "labels": np.asarray(labels, np.int32),
            "train_mask": masks["train"], "val_mask": masks["val"],
            "test_mask": masks["test"]}


def citation_graph(n: int, n_classes: int, feat_dim: int, avg_degree: float,
                   homophily: float, feature_signal: float, splits,
                   seed: int) -> dict:
    """The OGBN-Arxiv analogue as a dict of numpy arrays: ``indptr`` /
    ``indices`` (CSR, symmetric), ``features [n, F]`` f32, ``labels [n]``
    int32 and the boolean ``train_mask`` / ``val_mask`` / ``test_mask``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    dst, src = _sbm_edges(rng, labels, n_classes, avg_degree * homophily,
                          avg_degree * (1.0 - homophily))
    feats = _features(rng, labels, n_classes, feat_dim, feature_signal)
    return _csr(n, dst, src, feats, labels, splits, seed)


def edge_list(graph: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(dst, src)`` int64 arrays of every directed edge, CSR order."""
    indptr = graph["indptr"]
    dst = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                    np.diff(indptr))
    return dst, graph["indices"].astype(np.int64)
