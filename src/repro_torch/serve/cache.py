"""Per-partition embedding cache keyed by ``(layer, node-block)``.

Numpy copy of ``repro/serve/cache.py``: every layer's post-activation
output is stored on the host in partition-local blocks of ``block_nodes``
rows, so a query gathers its answer with two integer indirections (owner →
block → offset).  Invalidation is drift-gated by the shared halo-drift
predicate (:func:`repro_torch.dist.ratectl.stale.drift_skip`).
"""

from __future__ import annotations

import numpy as np

from repro_torch.dist.ratectl.stale import drift_skip

__all__ = ["EmbeddingCache"]


class EmbeddingCache:
    """Blocked activation store over a fixed partition assignment.

    ``owner[n]`` / ``local_index[n]`` are the partitioner's maps; ``put``
    ingests a padded ``[Q, P, F]`` layer stack (numpy), ``gather`` answers
    global node ids.

    Example::

        cache = EmbeddingCache(pg.owner, pg.local_index, pg.part_size)
        cache.put(0, hiddens[0].cpu().numpy())
        rows = cache.gather(0, [3, 17, 101])
    """

    def __init__(self, owner: np.ndarray, local_index: np.ndarray,
                 part_size: int, block_nodes: int = 128):
        self.owner = np.asarray(owner, np.int64)
        self.local = np.asarray(local_index, np.int64)
        self.part_size = int(part_size)
        self.block_nodes = max(int(block_nodes), 1)
        self.n_blocks = -(-self.part_size // self.block_nodes)
        self._store: dict[tuple[int, int, int], np.ndarray] = {}

    def put(self, layer: int, acts: np.ndarray) -> None:
        """Ingest one layer's ``[Q, P, F]`` padded activation stack,
        splitting each partition's rows into ``(layer, block)`` entries."""
        acts = np.asarray(acts)
        if acts.ndim != 3 or acts.shape[1] != self.part_size:
            raise ValueError(f"expected [Q, {self.part_size}, F] stack, "
                             f"got {acts.shape}")
        for qo in range(acts.shape[0]):
            for b in range(self.n_blocks):
                lo = b * self.block_nodes
                hi = min(lo + self.block_nodes, self.part_size)
                self._store[(layer, qo, b)] = np.array(acts[qo, lo:hi])

    def gather(self, layer: int, nodes) -> np.ndarray:
        """``[len(nodes), F]`` cached rows for global node ids."""
        nodes = np.asarray(nodes, np.int64)
        b, off = np.divmod(self.local[nodes], self.block_nodes)
        return np.stack([
            self._store[(layer, int(self.owner[node]), int(b[i]))][int(off[i])]
            for i, node in enumerate(nodes)])

    @staticmethod
    def plan_refresh(delta, age, threshold: float, max_stale: int):
        """The drift gate: ``[Q, Q]`` 0/1 skip mask — 1 keeps serving the
        cached halo at zero wire bits, 0 refreshes the pair through the
        wire.  This IS :func:`drift_skip`."""
        return drift_skip(delta, age, threshold, max_stale)
