"""Serving frontend: micro-batched queries over the distributed forward.

Counterpart of ``repro/serve/frontend.py``.  :class:`MicroBatcher` groups
multi-tenant node/edge queries by owning partition under a deadline-aware
batching window.  :class:`ServingEngine` is the runtime behind it: the
partitioned graph, the p2p halo wire with its pack/unpack and ELL kernels,
the quantised codecs and the ``auto:qos`` rate controller, re-used for
inference (``repro_torch.dist.gnn_parallel.make_infer_step``), with a
drift-gated :class:`repro_torch.serve.cache.EmbeddingCache` in front.
Cross-partition neighbourhoods route through the wire only on refresh;
between refreshes every query is a host cache gather at zero wire bits.
``apply_updates`` folds a streaming edge batch in and re-embeds only the
touched k-hop frontier (:mod:`repro_torch.serve.update`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.varco import CommLedger, CommPolicy
from repro_torch.dist.gnn_parallel import DistMeta, make_infer_step
from repro_torch.dist.halo import attach_p2p, pair_query_mass
from repro_torch.dist.ratectl import (RatePlan, exchange_widths,
                                      init_halo_cache, make_controller)
from repro_torch.graph.partition import build_partitioned, partition_graph
from repro_torch.nn.gnn import GNNConfig, params_to
from repro_torch.serve.cache import EmbeddingCache
from repro_torch.serve.update import apply_edge_updates, incremental_recompute

__all__ = ["MicroBatcher", "Query", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class Query:
    """One frontend request: a node embedding (``nodes == (u,)``) or an
    edge embedding (``nodes == (u, v)``, endpoint concat)."""
    nodes: tuple[int, ...]
    tenant: str = "default"
    arrival: float = 0.0


class MicroBatcher:
    """Deadline-aware per-partition micro-batching: queries queue under the
    partition owning their first node; :meth:`ready` trips when any
    partition batch reaches ``max_batch`` or the oldest waiting query has
    aged past ``window_s``."""

    def __init__(self, owner: np.ndarray, window_s: float = 2e-3,
                 max_batch: int = 64):
        self.owner = np.asarray(owner, np.int64)
        self.window_s = float(window_s)
        self.max_batch = max(int(max_batch), 1)
        self._queues: dict[int, deque[Query]] = {}
        self._oldest: float | None = None

    def submit(self, nodes, tenant: str = "default",
               now: float | None = None) -> Query:
        now = time.monotonic() if now is None else now
        nodes = tuple(int(v) for v in (nodes if hasattr(nodes, "__len__")
                                       else (nodes,)))
        if not 1 <= len(nodes) <= 2:
            raise ValueError(f"a query names 1 node or 2 edge endpoints, "
                             f"got {len(nodes)}")
        qy = Query(nodes, tenant, now)
        self._queues.setdefault(int(self.owner[nodes[0]]),
                                deque()).append(qy)
        # true minimum: callers may feed explicit, out-of-order stamps
        if self._oldest is None or now < self._oldest:
            self._oldest = now
        return qy

    @property
    def pending(self) -> int:
        return sum(len(dq) for dq in self._queues.values())

    def ready(self, now: float | None = None) -> bool:
        if not self.pending:
            return False
        if any(len(dq) >= self.max_batch for dq in self._queues.values()):
            return True
        now = time.monotonic() if now is None else now
        return now - self._oldest >= self.window_s

    def drain(self) -> dict[int, list[Query]]:
        """Pop everything as ``{partition: [Query, ...]}`` (arrival order
        preserved within a partition)."""
        out = {p: list(dq) for p, dq in self._queues.items() if dq}
        self._queues.clear()
        self._oldest = None
        return out


class ServingEngine:
    """Distributed GNN inference server over one partitioned graph.

    Lifecycle: ``refresh(force=True)`` cold-starts the cache with one
    exact (rate-1, fp32) distributed forward; ``serve`` answers queries
    from the cache; periodic ``refresh()`` re-ships only the pairs whose
    measured halo drift crossed the gate, at the ``auto:qos`` controller's
    rate × width (query-mass weighted); ``apply_updates`` folds an edge
    batch in and re-embeds the touched k-hop frontier.

    ``status()`` is ``"FRESH"`` while the cache provably equals a full
    fresh fp32 forward and ``"CACHED"`` otherwise.  ``device`` (default
    ``"cuda"``) holds the graph, the parameters and every activation;
    requesting CUDA where there is none raises.  ``rounding`` (``"rint"``
    or ``"stochastic"``) is the quantised wire's rounding, under the JAX
    package's ``round_key`` stream.  ``timing`` holds the last refresh's
    forward and host-copy seconds, or the last update's seconds: the host
    spill, the gather of the old stack, the recompute on the device and
    the rebuild (partition, engine, cache).

    Example::

        eng = ServingEngine(g, params, cfg, q=4)
        eng.refresh(force=True)
        emb, status = eng.serve([3, 17])       # status == "FRESH"
    """

    def __init__(self, g, params: dict, cfg: GNNConfig, q: int = 4, *,
                 device="cuda", policy: CommPolicy | str | None = None,
                 scheme: str = "metis-like", seed: int = 0,
                 refresh_horizon: int = 64, threshold: float = 0.05,
                 max_stale: int = 8, block_nodes: int = 128,
                 window_s: float = 2e-3, max_batch: int = 64,
                 rounding: str = "rint"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine was asked for a CUDA device but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain versions on the CPU")
        if cfg.conv != "sage":
            raise ValueError("the serving engine is sage-only, got "
                             f"conv={cfg.conv!r}")
        self.g, self.cfg, self.q = g, cfg, q
        self.params = params_to(params, self.device)
        self.threshold, self.max_stale = float(threshold), int(max_stale)
        self.block_nodes, self.rounding = block_nodes, rounding
        self.refresh_horizon = int(refresh_horizon)
        self.pg = partition_graph(g, q, scheme=scheme, seed=seed)
        self.owner = np.asarray(self.pg.owner, np.int64)
        # FIXED across refreshes: the kept lane-block sets are identical
        # refresh-to-refresh, so pair_delta measures real activation drift
        self._key = prng.key(seed)
        if policy is None:
            # default qos budget: half the full-rate refresh spend
            full = 32.0 * float(self._full_refresh_bits())
            policy = f"auto:qos:{0.5 * full * self.refresh_horizon:g}:w8"
        if isinstance(policy, str):
            policy = CommPolicy.parse(policy, self.refresh_horizon)
        self.policy = policy
        self.batcher = MicroBatcher(self.owner, window_s=window_s,
                                    max_batch=max_batch)
        self.ledger = CommLedger.zero()
        self.timing: dict[str, float] = {}
        self._qcount = np.zeros(q, np.float64)
        self._step = 0
        self._exact = False
        self._rebuild(self.pg)

    def _full_refresh_bits(self) -> float:
        return float(self.pg.halo_demand) * sum(exchange_widths(self.cfg))

    def _rebuild(self, pg) -> None:
        """Build everything hanging off the partitioned graph: the device
        graph, DistMeta, the inference step, the controller, the drift-gate
        state and the embedding cache."""
        self.pg = pg
        self.graph = attach_p2p(pg.device_arrays(self.device), pg,
                                self.device)
        self.meta = DistMeta.build(pg, self.params, wire="p2p")
        self.infer = make_infer_step(self.cfg, self.policy, self.meta,
                                     rounding=self.rounding)
        self.ctl = make_controller(self.policy, self.meta, self.cfg,
                                   self.refresh_horizon)
        self._ctl_state = self.ctl.init()
        self._halo_cache = init_halo_cache(self.meta, self.cfg, self.device)
        self._age = np.zeros((self.q, self.q), np.float32)
        self._skip_next = np.zeros((self.q, self.q), np.float32)
        self.cache = EmbeddingCache(pg.owner, pg.local_index, pg.part_size,
                                    block_nodes=self.block_nodes)

    # -- refresh ----------------------------------------------------------

    def refresh(self, force: bool = False) -> dict:
        """One distributed forward refreshing the embedding cache.

        ``force=True`` is the cold-start / resync path: rate 1, fp32, no
        drift skips.  Otherwise the qos controller plans the pair rate ×
        width map and the drift gate decides which pairs serve from the
        halo cache.  Returns the step metrics (float32 CPU tensors)."""
        q = self.q
        if force:
            plan = RatePlan(np.ones((q, q), np.float32),
                            np.zeros((q, q), np.float32), None)
        else:
            plan, self._ctl_state = self.ctl.plan(self._ctl_state,
                                                  self._step)
            plan = plan._replace(skip=self._skip_next.copy())
        skip = np.asarray(plan.skip, np.float32)
        t0 = time.perf_counter()
        _, hidden, m, self._halo_cache = self.infer(
            self.params, self.graph, self._key, plan, self._halo_cache)
        t1 = time.perf_counter()
        for li, h in enumerate(hidden):
            self.cache.put(li, h.cpu().numpy())
        self.timing = {"forward_s": t1 - t0,
                       "host_copy_s": time.perf_counter() - t1}
        delta = m["pair_delta"].numpy()
        self._age = np.where(skip > 0.0, self._age + 1.0,
                             0.0).astype(np.float32)
        self._skip_next = self.cache.plan_refresh(
            delta, self._age, self.threshold, self.max_stale)
        obs = {"transport_bits": m["transport_bits"],
               "pair_err": m["pair_err"], "pair_delta": m["pair_delta"],
               "query_mass": pair_query_mass(self.meta.pair_table(),
                                             self._qcount)}
        self._ctl_state = self.ctl.observe(self._ctl_state, obs)
        self._qcount[:] = 0.0
        self.ledger = self.ledger.add_bits(m["halo_bits"],
                                           m["transport_bits"])
        off = ~np.eye(q, dtype=bool)
        self._exact = True if force else \
            bool(self._exact and np.all(skip[off] >= 1.0))
        self._step += 1
        return m

    def status(self) -> str:
        return "FRESH" if self._exact else "CACHED"

    # -- queries ----------------------------------------------------------

    def serve(self, nodes) -> tuple[np.ndarray, str]:
        """Final-layer embeddings ``[len(nodes), out_dim]`` for global node
        ids, straight from the cache (zero wire bits)."""
        nodes = np.asarray(nodes, np.int64)
        np.add.at(self._qcount, self.owner[nodes], 1.0)
        emb = self.cache.gather(len(self.params["layers"]) - 1, nodes)
        return emb, self.status()

    def serve_edges(self, pairs) -> tuple[np.ndarray, str]:
        """Edge queries: ``[len(pairs), 2·out_dim]`` endpoint concat."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        u, _ = self.serve(pairs[:, 0])
        v, status = self.serve(pairs[:, 1])
        return np.concatenate([u, v], axis=-1), status

    def submit(self, nodes, tenant: str = "default",
               now: float | None = None) -> Query:
        """Enqueue one query into the micro-batching window."""
        return self.batcher.submit(nodes, tenant, now=now)

    def flush(self, now: float | None = None,
              force: bool = False) -> list[tuple[Query, np.ndarray]]:
        """Answer every waiting query if the batching window tripped
        (``ready``) or ``force=True``.  Returns ``(query, embedding)``
        pairs."""
        if not force and not self.batcher.ready(now):
            return []
        out: list[tuple[Query, np.ndarray]] = []
        for _, batch in sorted(self.batcher.drain().items()):
            for qy in batch:
                if len(qy.nodes) == 1:
                    emb, _ = self.serve([qy.nodes[0]])
                else:
                    emb, _ = self.serve_edges([qy.nodes])
                out.append((qy, emb[0]))
        return out

    # -- streaming updates -------------------------------------------------

    def apply_updates(self, inserts=None, deletes=None
                      ) -> tuple[np.ndarray, list[np.ndarray]]:
        """Fold an undirected edge insert/delete batch into the served
        graph: rebuild the CSR through the ``EdgeSpill`` path on the host,
        re-embed only the k-hop frontier of the touched endpoints on
        ``self.device`` (:func:`repro_torch.serve.update.
        incremental_recompute`), repartition on the UNCHANGED owner
        vector, and reset the drift gate (the halo caches refer to the old
        topology).  Returns ``(touched, per-layer frontiers)``; the status
        becomes ``"CACHED"`` (≤ 1e-5 of a fresh forward, not bitwise)."""
        n = self.g.num_nodes
        t0 = time.perf_counter()
        g2, touched = apply_edge_updates(self.g, inserts, deletes)
        t1 = time.perf_counter()
        hidden_old = [self.cache.gather(li, np.arange(n))
                      for li in range(len(self.params["layers"]))]
        t2 = time.perf_counter()
        hidden_new, frontiers = incremental_recompute(
            self.params, self.cfg, g2, hidden_old, touched,
            device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        self.g = g2
        self._rebuild(build_partitioned(g2, self.owner, self.q))
        for li, h in enumerate(hidden_new):
            self.cache.put(li, self._to_blocks(h.cpu().numpy()))
        self._exact = False
        self.timing = {"spill_s": t1 - t0, "gather_s": t2 - t1,
                       "recompute_s": t3 - t2,
                       "rebuild_s": time.perf_counter() - t3}
        return touched, frontiers

    def _to_blocks(self, garr: np.ndarray) -> np.ndarray:
        """Global ``[n, F]`` rows → padded ``[Q, P, F]`` stack."""
        out = np.zeros((self.q, self.pg.part_size, garr.shape[1]),
                       np.float32)
        idx = np.arange(len(garr))
        out[self.owner[idx],
            np.asarray(self.pg.local_index, np.int64)[idx]] = garr
        return out

    def query_counts(self) -> np.ndarray:
        """Per-partition query counts since the last refresh (the qos
        controller's raw mass signal)."""
        return self._qcount.copy()
