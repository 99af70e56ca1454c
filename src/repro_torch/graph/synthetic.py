"""Synthetic analogues of the paper's datasets (numpy copy of the in-memory
generators of ``repro.graph.synthetic``; the same seed gives bitwise the
same graph).

* ``citation_graph`` — OGBN-Arxiv analogue: SBM community structure
  correlated with the 40 labels, 128-dim noisy class-centroid features.
* ``tiny_graph``     — small deterministic graph for unit tests.

The streaming generators of the JAX package are not ported yet.
"""

from __future__ import annotations

import numpy as np

from .data import GraphData, from_edge_list


def _sbm_edges(rng: np.random.Generator, labels: np.ndarray, n_classes: int,
               avg_deg_in: float, avg_deg_out: float
               ) -> tuple[np.ndarray, np.ndarray]:
    """Sample SBM edges block-pair-wise in O(E)."""
    n = len(labels)
    class_nodes = [np.flatnonzero(labels == c) for c in range(n_classes)]
    sizes = np.array([len(c) for c in class_nodes], np.float64)
    dsts, srcs = [], []
    for ci in range(n_classes):
        ni = sizes[ci]
        if ni < 2:
            continue
        # intra-block
        m_in = rng.poisson(ni * avg_deg_in / 2.0)
        if m_in:
            dsts.append(rng.choice(class_nodes[ci], m_in))
            srcs.append(rng.choice(class_nodes[ci], m_in))
        # inter-block: connect to a few random other blocks
        m_out = rng.poisson(ni * avg_deg_out / 2.0)
        if m_out:
            dsts.append(rng.choice(class_nodes[ci], m_out))
            srcs.append(rng.integers(0, n, m_out))
    return np.concatenate(dsts), np.concatenate(srcs)


def _features(rng: np.random.Generator, labels: np.ndarray, n_classes: int,
              dim: int, signal: float) -> np.ndarray:
    """Noisy class-centroid features; ``signal`` sets feature informativeness."""
    centroids = rng.normal(0.0, 1.0, (n_classes, dim)).astype(np.float32)
    noise = rng.normal(0.0, 1.0, (len(labels), dim)).astype(np.float32)
    feats = signal * centroids[labels] + noise
    # row-normalise (the paper assumes normalised signals)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-6
    return feats


def citation_graph(n: int = 20000, n_classes: int = 40, feat_dim: int = 128,
                   avg_degree: float = 13.8, homophily: float = 0.82,
                   feature_signal: float = 0.06, seed: int = 0) -> GraphData:
    """OGBN-Arxiv analogue (169k nodes / 1.17M edges scaled to ``n``).

    ``avg_degree`` matches Arxiv's 2|E|/n ≈ 13.8; ``homophily`` is the
    fraction of edge mass that stays intra-class.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    deg_in = avg_degree * homophily
    deg_out = avg_degree * (1.0 - homophily)
    dst, src = _sbm_edges(rng, labels, n_classes, deg_in, deg_out)
    feats = _features(rng, labels, n_classes, feat_dim, feature_signal)
    return from_edge_list(n, dst, src, feats, labels,
                          splits=(0.54, 0.18, 0.28), seed=seed,
                          name=f"synth-arxiv-{n}")


def tiny_graph(n: int = 256, n_classes: int = 4, feat_dim: int = 16,
               seed: int = 0) -> GraphData:
    """Small deterministic graph for unit tests."""
    return citation_graph(n=n, n_classes=n_classes, feat_dim=feat_dim,
                          avg_degree=8.0, homophily=0.85,
                          feature_signal=0.3, seed=seed)
