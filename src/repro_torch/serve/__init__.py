"""Distributed GNN inference serving over the p2p halo wire:
:class:`ServingEngine` (micro-batched queries, drift-gated embedding cache,
``auto:qos`` rate × width control, streaming edge updates) and
:class:`EmbeddingCache`; :func:`apply_edge_updates` and
:func:`incremental_recompute` are the update path's two halves.

Example::

    from repro_torch.serve import ServingEngine
    eng = ServingEngine(g, params, cfg, q=4)   # device="cuda"
    eng.refresh(force=True)                    # cold start: exact halos
    emb, status = eng.serve([3, 17, 101])      # status == "FRESH"
"""

from repro_torch.serve.cache import EmbeddingCache
from repro_torch.serve.frontend import MicroBatcher, Query, ServingEngine
from repro_torch.serve.update import apply_edge_updates, incremental_recompute

__all__ = ["EmbeddingCache", "MicroBatcher", "Query", "ServingEngine",
           "apply_edge_updates", "incremental_recompute"]
