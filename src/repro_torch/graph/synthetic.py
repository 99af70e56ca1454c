"""Synthetic analogues of the paper's datasets (numpy copy of
``repro.graph.synthetic``; the same seed gives bitwise the same graph, and
the streaming generators bitwise the same store).

* ``citation_graph``   — OGBN-Arxiv analogue: SBM community structure
  correlated with the 40 labels, 128-dim noisy class-centroid features.
* ``copurchase_graph`` — OGBN-Products analogue: heavier, hub-dominated
  degree profile (power-law overlay on an SBM), 47 classes, 100-dim feats.
* ``tiny_graph``       — small deterministic graph for unit tests.
* ``stream_sbm_graph`` / ``stream_powerlaw_graph`` — the same two
  structures streamed straight to an on-disk ``GraphStore``
  (``repro_torch.graph.stream``) at scales that never fit in memory.
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


def copurchase_graph(n: int = 50000, n_classes: int = 47, feat_dim: int = 100,
                     avg_degree: float = 25.0, homophily: float = 0.88,
                     hub_fraction: float = 0.01, hub_degree: float = 200.0,
                     feature_signal: float = 0.08, seed: int = 1) -> GraphData:
    """OGBN-Products analogue: SBM + power-law hub overlay.

    Products has avg degree ≈ 50 and extreme hubs; we scale degree down with
    node count but keep the hub-heavy profile that stresses partition cuts.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    dst, src = _sbm_edges(rng, labels, n_classes,
                          avg_degree * homophily,
                          avg_degree * (1.0 - homophily))
    # hub overlay: a few nodes attach to many random nodes (co-purchase hubs)
    n_hubs = max(int(hub_fraction * n), 1)
    hubs = rng.choice(n, n_hubs, replace=False)
    m_hub = rng.poisson(hub_degree, n_hubs)
    hub_dst = np.repeat(hubs, m_hub)
    hub_src = rng.integers(0, n, int(m_hub.sum()))
    dst = np.concatenate([dst, hub_dst])
    src = np.concatenate([src, hub_src])
    feats = _features(rng, labels, n_classes, feat_dim, feature_signal)
    return from_edge_list(n, dst, src, feats, labels,
                          splits=(0.08, 0.02, 0.90), seed=seed,
                          name=f"synth-products-{n}")


def tiny_graph(n: int = 256, n_classes: int = 4, feat_dim: int = 16,
               seed: int = 0) -> GraphData:
    """Small deterministic graph for unit tests."""
    return citation_graph(n=n, n_classes=n_classes, feat_dim=feat_dim,
                          avg_degree=8.0, homophily=0.85,
                          feature_signal=0.3, seed=seed)


# ---------------------------------------------------------------------------
# Streaming generators (10⁷–10⁸ nodes): emit straight to a GraphStore
# ---------------------------------------------------------------------------
#
# The in-memory generators above materialise every edge and feature at
# once; these stream both to disk through the external sort of
# ``repro_torch.graph.stream`` in fixed 65536-node generation chunks, so peak
# memory is O(chunk) regardless of ``n`` — and the result is
# bit-identical for any io chunking (the generation chunk is an internal
# constant, and the chunked-CSR content is canonical under dedup).
#
# Class labels come from an affine permutation ``π(i) = (a·i+b) mod n``
# (gcd(a, n) = 1): ``label(i) = π(i) mod C`` scatters classes uniformly,
# yet the k-th member of class ``c`` is recoverable in O(1) as
# ``π⁻¹(c + C·k)`` — which is what lets a generation chunk sample
# *same-class* SBM partners without a per-class node index (the
# ``class_nodes`` lists above are O(n) pointers we can't afford).

_GEN_CHUNK = 65536


def _affine(n: int, salt: int):
    """A fixed-point-free-ish affine permutation of [0, n) and its
    inverse multiplier (``a`` odd and coprime with ``n``)."""
    import math

    a = (2 * salt + 1) % n or 1
    while math.gcd(a, n) != 1:
        a = (a + 2) % n or 1
    return a, pow(a, -1, n), (salt * 2654435761 + 12345) % n


class _StreamLabels:
    """Label / split / feature oracle shared by the streaming generators."""

    def __init__(self, n, n_classes, feat_dim, signal, splits, seed):
        self.n, self.c, self.f = n, n_classes, feat_dim
        self.signal, self.splits, self.seed = signal, splits, seed
        self.a, self.a_inv, self.b = _affine(n, seed + 7)
        self.a2, _, self.b2 = _affine(n, seed + 101)
        # members of class c are y ≡ c (mod C), y ∈ [0, n)
        self.class_count = np.array(
            [(n - c - 1) // n_classes + 1 if c < n else 0
             for c in range(n_classes)], np.int64)
        rng = np.random.default_rng([seed, 29])
        self.centroids = rng.normal(
            0.0, 1.0, (n_classes, feat_dim)).astype(np.float32)

    def label(self, u: np.ndarray) -> np.ndarray:
        return (((self.a * u.astype(np.int64) + self.b) % self.n)
                % self.c).astype(np.int32)

    def member(self, c: np.ndarray, k: np.ndarray) -> np.ndarray:
        """The k-th node of class c (π⁻¹ of the class lattice)."""
        y = c.astype(np.int64) + self.c * k.astype(np.int64)
        return (self.a_inv * (y - self.b)) % self.n

    def node_writer(self, lo: int, hi: int) -> dict:
        """Payload for node rows [lo, hi): generated per aligned
        _GEN_CHUNK block so the content is io-chunking-independent."""
        feats = np.empty((hi - lo, self.f), np.float32)
        for g0 in range(lo - lo % _GEN_CHUNK, hi, _GEN_CHUNK):
            g1 = min(g0 + _GEN_CHUNK, self.n)
            rng = np.random.default_rng([self.seed, 23, g0 // _GEN_CHUNK])
            noise = rng.normal(0.0, 1.0,
                               (g1 - g0, self.f)).astype(np.float32)
            s0, s1 = max(lo, g0), min(hi, g1)
            lab = self.label(np.arange(s0, s1))
            block = self.signal * self.centroids[lab] + \
                noise[s0 - g0:s1 - g0]
            block /= np.linalg.norm(block, axis=1, keepdims=True) + 1e-6
            feats[s0 - lo:s1 - lo] = block
        u = np.arange(lo, hi)
        r = ((self.a2 * u.astype(np.int64) + self.b2) % self.n) / self.n
        s_tr, s_va = self.splits[0], self.splits[0] + self.splits[1]
        return {"features": feats, "labels": self.label(u),
                "train_mask": r < s_tr,
                "val_mask": (r >= s_tr) & (r < s_va),
                "test_mask": r >= s_va}


def stream_sbm_graph(path, n: int = 1_000_000, n_classes: int = 40,
                     feat_dim: int = 64, avg_degree: float = 8.0,
                     homophily: float = 0.85, feature_signal: float = 0.1,
                     splits=(0.6, 0.2, 0.2), seed: int = 0,
                     chunk_nodes: int | None = None,
                     chunk_edges: int | None = None):
    """SBM streamed to disk: the ``citation_graph`` structure at scales
    that never fit in memory.  Returns the :class:`GraphStore`."""
    from . import stream as st

    ora = _StreamLabels(n, n_classes, feat_dim, feature_signal, splits,
                        seed)
    p_in = avg_degree * homophily / 2.0        # undirected stubs per node
    p_out = avg_degree * (1.0 - homophily) / 2.0

    def emit(spill):
        for g0 in range(0, n, _GEN_CHUNK):
            g1 = min(g0 + _GEN_CHUNK, n)
            rng = np.random.default_rng([seed, 17, g0 // _GEN_CHUNK])
            u = np.arange(g0, g1, dtype=np.int64)
            # intra-class: partner is a uniform member of u's class
            ui = np.repeat(u, rng.poisson(p_in, len(u)))
            ci = ora.label(ui)
            vi = ora.member(ci, rng.integers(
                0, ora.class_count[ci], len(ui)))
            # inter-class: uniform partner anywhere
            uo = np.repeat(u, rng.poisson(p_out, len(u)))
            vo = rng.integers(0, n, len(uo))
            dst = np.concatenate([ui, vi, uo, vo])
            src = np.concatenate([vi, ui, vo, uo])   # both directions
            spill.add(dst, src)

    return st.spill_to_store(
        n, emit, path, name=f"stream-sbm-{n}", node_writer=ora.node_writer,
        feat_dim=feat_dim, num_classes=n_classes,
        chunk_nodes=chunk_nodes or st.CHUNK_NODES,
        chunk_edges=chunk_edges or st.CHUNK_EDGES)


def stream_powerlaw_graph(path, n: int = 1_000_000, n_classes: int = 47,
                          feat_dim: int = 64, avg_degree: float = 8.0,
                          alpha: float = 2.3, feature_signal: float = 0.1,
                          splits=(0.6, 0.2, 0.2), seed: int = 1,
                          chunk_nodes: int | None = None,
                          chunk_edges: int | None = None):
    """Chung-Lu power-law graph streamed to disk (``p(deg) ∝ deg^-alpha``
    — the hub-dominated profile of ``copurchase_graph`` at scale).

    Each node draws stubs proportional to its weight ``w(r) ∝ (r+1)^-γ``
    (``γ = 1/(alpha-1)``, rank ``r = π(i)`` so hubs scatter across the id
    space) and partners are sampled by inverse-CDF of the same weight
    law, giving the heavy-tailed joint degree profile that stresses
    partition cuts.  Returns the :class:`GraphStore`.
    """
    from . import stream as st

    ora = _StreamLabels(n, n_classes, feat_dim, feature_signal, splits,
                        seed)
    gamma = 1.0 / (alpha - 1.0)
    # mean weight over ranks, streamed (no O(n) resident vector)
    mean_w = 0.0
    for g0 in range(0, n, _GEN_CHUNK):
        r = np.arange(g0, min(g0 + _GEN_CHUNK, n), dtype=np.float64)
        mean_w += float(((r + 1.0) ** -gamma).sum())
    mean_w /= n
    a, a_inv, b = _affine(n, seed + 51)
    top = float(n) ** (1.0 - gamma)

    def emit(spill):
        for g0 in range(0, n, _GEN_CHUNK):
            g1 = min(g0 + _GEN_CHUNK, n)
            rng = np.random.default_rng([seed, 19, g0 // _GEN_CHUNK])
            u = np.arange(g0, g1, dtype=np.int64)
            rank = (a * u + b) % n
            w = (rank.astype(np.float64) + 1.0) ** -gamma
            stubs = rng.poisson(avg_degree * w / (2.0 * mean_w))
            us = np.repeat(u, stubs)
            # partner rank by inverse CDF of x^-γ on [1, n]
            x = (rng.random(len(us)) * (top - 1.0) + 1.0) \
                ** (1.0 / (1.0 - gamma))
            pr = np.minimum(x.astype(np.int64), n - 1)
            vs = (a_inv * (pr - b)) % n
            spill.add(np.concatenate([us, vs]), np.concatenate([vs, us]))

    return st.spill_to_store(
        n, emit, path, name=f"stream-powerlaw-{n}",
        node_writer=ora.node_writer, feat_dim=feat_dim,
        num_classes=n_classes,
        chunk_nodes=chunk_nodes or st.CHUNK_NODES,
        chunk_edges=chunk_edges or st.CHUNK_EDGES)


DATASETS = {
    "synth-arxiv": citation_graph,
    "synth-products": copurchase_graph,
    "tiny": tiny_graph,
}

STREAM_DATASETS = {
    "stream-sbm": stream_sbm_graph,
    "stream-powerlaw": stream_powerlaw_graph,
}


def load(name: str, **kw) -> GraphData:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](**kw)
