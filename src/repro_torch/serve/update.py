"""Streaming graph updates: edge batches → k-hop frontier recompute.

Counterpart of ``repro/serve/update.py``.  Two halves:

* :func:`apply_edge_updates` — host numpy: fold an insert/delete edge
  batch into a :class:`repro_torch.graph.data.GraphData` through
  :class:`repro_torch.graph.stream.EdgeSpill` in its signed-weight mode
  (existing edges and inserts spill ``+1``, deletes ``-1``; the bucket
  sort sums duplicates and ``drop_nonpositive`` removes cancelled edges),
  returning the rebuilt graph and the **touched** node set.  The CSR is
  the JAX package's exactly.
* :func:`incremental_recompute` — on the device: re-embed only the k-hop
  frontier of the touched nodes.  Layer ``l``'s dirty set is ``S_l = T ∪
  nbrs(S_{l-1})`` (a row's output changes iff it is an update endpoint or
  it aggregates a neighbour whose previous-layer row changed); only those
  rows are recomputed against the patched previous layer, and everything
  outside the frontier keeps its cached activations.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.graph.data import GraphData, normalized_edge_weights
from repro_torch.graph.stream import EdgeSpill
from repro_torch.models.transformer import checked_device
from repro_torch.nn.gnn import GNNConfig, params_to
from repro_torch.nn.modules import dense

__all__ = ["apply_edge_updates", "incremental_recompute"]


def apply_edge_updates(g: GraphData, inserts=None, deletes=None,
                       workdir: str | None = None,
                       bucket_nodes: int = 1 << 14
                       ) -> tuple[GraphData, np.ndarray]:
    """Rebuild ``g`` with an undirected edge batch applied.

    ``inserts`` / ``deletes`` are ``(dst, src)`` array pairs (undirected:
    both directions are spilled).  Inserting a present edge or deleting
    an absent one is a no-op after the signed-weight netting — the
    canonical rows keep an edge iff its summed weight is positive.
    Features, labels and split masks carry over unchanged; ``touched``
    is the sorted unique endpoint set of the batch (the frontier seed of
    :func:`incremental_recompute`).  The spill lives in a temporary
    directory under ``workdir`` (default: the system's temp dir).

    Example::

        g2, touched = apply_edge_updates(g, inserts=(dst_new, src_new),
                                         deletes=(dst_old, src_old))
    """
    n = g.num_nodes

    def _pair(batch):
        if batch is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        d, s = batch
        return np.asarray(d, np.int64), np.asarray(s, np.int64)

    ins_d, ins_s = _pair(inserts)
    del_d, del_s = _pair(deletes)
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        spill = EdgeSpill(n, os.path.join(td, "spill"),
                          bucket_nodes=bucket_nodes, weighted=True,
                          drop_nonpositive=True)
        dst0, src0 = g.edge_list()
        if len(dst0):
            spill.add(dst0, src0)          # existing directed rows: +1
        for d, s, w in ((ins_d, ins_s, 1.0), (del_d, del_s, -1.0)):
            if len(d):
                both_d = np.concatenate([d, s])
                both_s = np.concatenate([s, d])
                spill.add(both_d, both_s,
                          np.full(len(both_d), w, np.float64))
        dst, src, _ = spill.canonical_edges()
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst.astype(np.int64) + 1, 1)
    g2 = GraphData(indptr=np.cumsum(indptr), indices=src.astype(np.int32),
                   features=g.features, labels=g.labels,
                   train_mask=g.train_mask, val_mask=g.val_mask,
                   test_mask=g.test_mask, name=g.name)
    g2.validate()
    touched = np.unique(np.concatenate([ins_d, ins_s, del_d, del_s]))
    return g2, touched.astype(np.int64)


def incremental_recompute(params: dict, cfg: GNNConfig, g: GraphData,
                          hidden_prev: list, touched: np.ndarray,
                          norm: str = "mean", device="cuda"
                          ) -> tuple[list[torch.Tensor], list[np.ndarray]]:
    """Patch a cached per-layer activation stack after a graph update.

    ``hidden_prev`` is the full-graph ``[n, F_l]`` stack (numpy arrays or
    tensors) computed on the OLD graph — the serving cache's global
    gather; ``g`` is the NEW graph; ``touched`` the update batch's
    endpoint set.  Returns the patched stack as float32 tensors on
    ``device`` and the per-layer frontier sets actually recomputed
    (numpy int64) — ``frontiers[l]`` grows one hop per layer, so the work
    is ``O(Σ_l |S_l| · d̄ · F)`` instead of a full ``O(n)`` forward.  Each
    frontier row's mean-aggregate is an ``index_add_`` over the edges
    that end in the frontier.

    Only the ``sage`` conv is supported (the poly conv's tap chain hops
    ``k_taps - 1`` times *inside* a layer, so its frontier bookkeeping
    differs; the serving engine is sage-only).
    """
    if cfg.conv != "sage":
        raise ValueError(f"incremental recompute supports conv='sage', "
                         f"got {cfg.conv!r}")
    device = checked_device(device)
    layers = params_to(params, device)["layers"]
    if len(hidden_prev) != len(layers):
        raise ValueError(f"hidden_prev has {len(hidden_prev)} layers, "
                         f"model has {len(layers)}")
    n = g.num_nodes
    dst_np, src_np = g.edge_list()
    dst = torch.from_numpy(dst_np.astype(np.int64)).to(device)
    src = torch.from_numpy(src_np.astype(np.int64)).to(device)
    w = torch.from_numpy(np.asarray(normalized_edge_weights(g, kind=norm),
                                    np.float32)).to(device)
    t_idx = torch.from_numpy(np.unique(np.asarray(touched, np.int64))) \
        .to(device)
    hidden = [torch.as_tensor(h).to(device=device, dtype=torch.float32)
              .clone() for h in hidden_prev]
    x = torch.from_numpy(np.asarray(g.features, np.float32)).to(device)
    frontiers: list[np.ndarray] = []
    dirty = torch.zeros(n, dtype=torch.bool, device=device)
    dirty[t_idx] = True
    with torch.no_grad():
        for li, layer in enumerate(layers):
            # rows reading a dirty previous-layer value join the frontier
            if li > 0:
                grow = torch.zeros_like(dirty)
                grow[dst[dirty[src]]] = True
                dirty = grow
                dirty[t_idx] = True
            s_nodes = torch.nonzero(dirty).squeeze(1)
            frontiers.append(s_nodes.cpu().numpy().astype(np.int64))
            if not len(s_nodes):
                continue
            h_in = x if li == 0 else hidden[li - 1]
            # frontier-local row of every node (-1 outside the frontier)
            row = torch.full((n,), -1, dtype=torch.int64, device=device)
            row[s_nodes] = torch.arange(len(s_nodes), device=device)
            sel = dirty[dst]
            agg = torch.zeros((len(s_nodes), h_in.shape[1]),
                              dtype=torch.float32, device=device)
            agg.index_add_(0, row[dst[sel]],
                           h_in[src[sel]] * w[sel, None])
            h_self = h_in[s_nodes]
            h_new = dense(layer["self"], h_self) + \
                dense(layer["neigh"], agg)
            if cfg.residual and h_new.shape[1] == h_in.shape[1]:
                h_new = h_new + h_self
            if li < len(layers) - 1:
                h_new = torch.relu(h_new)
            hidden[li][s_nodes] = h_new
    return hidden, frontiers
