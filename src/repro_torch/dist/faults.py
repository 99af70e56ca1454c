"""Deterministic fault injection + graceful degradation.

Counterpart of ``repro/dist/faults.py`` on the emulated backend.  The
variable-rate scheme treats the wire as unreliable-by-budget; this module
treats it as unreliable-by-nature and keeps the same training loop
running through three failure classes:

* **link drops / latency spikes** — :class:`FaultSchedule` derives a
  per-step ``[Q, Q]`` link-drop mask and per-link latency multipliers
  from a counter-based numpy Philox stream keyed on ``(seed, step)``
  (the JAX package's streams, bit for bit): the schedule is a pure
  function of its arguments, and masks are always drawn at the
  *original* Q with the surviving rows/columns selected, so a crash
  never perturbs the remaining links' fault streams;
* **degraded halo service** — :func:`degrade_plan` runs the ladder
  *exchange → cached → backoff-probe → local-only*: a dropped pair serves
  the receiver's cached hop buffer (charging zero wire bits) while its
  ``age`` stays under ``max_stale``; past the cap the pair goes **dead**
  — its rows are zeroed, the local aggregation renormalises toward the
  isolated (No-Comm) weights, and the link is re-probed under capped
  exponential backoff until a probe lands;
* **worker crashes** — a ``crash_at`` event drops the run to ``Q - 1``:
  :func:`shrink_shards` renumbers a
  :class:`repro_torch.graph.stream.ShardSet` around the dead partition,
  :func:`migrate_controller_state` carries the rate controller's pair
  state across, and the trainer resumes at the smaller Q.

The fault cache channel is separate from the ``stale`` controller's so
degradation works under every policy.

Example::

    faults = FaultSchedule(q=4, seed=0, drop_rate=0.25,
                           crash_at=((3, 1),))
    res = train_gnn(shard_dir, policy=CommPolicy.parse("full", epochs),
                    faults=faults, wire="p2p")
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.spans import span

#: degradation-ladder serve modes per ordered pair (receiver × sender)
FRESH, CACHED, DEAD = 0, 1, 2


# ---------------------------------------------------------------------------
# Deterministic schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Replayable fault plan: a pure function of ``(seed, step)``.

    ``q`` is the *original* worker count; ``alive`` the original indices
    still running (``None`` = all).  ``crash_at`` holds ``(step,
    original_worker)`` events.  ``drop_rate`` is the per-step per-ordered-
    pair Bernoulli drop probability; ``spike_rate``/``spike_factor`` model
    latency spikes (a link slower than ``spike_threshold``× is treated as
    dark for the step — the DistGNN-style "serve stale rather than
    stall" rule).
    """

    q: int
    seed: int = 0
    drop_rate: float = 0.0
    spike_rate: float = 0.0
    spike_factor: float = 8.0
    spike_threshold: float = 4.0
    crash_at: tuple = ()
    alive: tuple | None = None

    def __post_init__(self):
        if not 0.0 <= self.drop_rate <= 1.0:
            raise ValueError(f"drop_rate must be in [0, 1], "
                             f"got {self.drop_rate}")
        if not 0.0 <= self.spike_rate <= 1.0:
            raise ValueError(f"spike_rate must be in [0, 1], "
                             f"got {self.spike_rate}")
        if self.alive is not None:
            if sorted(set(self.alive)) != list(self.alive):
                raise ValueError("alive must be sorted unique indices")
            if any(not 0 <= a < self.q for a in self.alive):
                raise ValueError(f"alive indices must be in [0, {self.q})")

    @property
    def alive_workers(self) -> tuple:
        return tuple(range(self.q)) if self.alive is None else self.alive

    @property
    def cur_q(self) -> int:
        return len(self.alive_workers)

    def _gen(self, step: int) -> np.random.Generator:
        # counter-based: one independent, reconstructible stream per step
        return np.random.Generator(np.random.Philox(
            key=[int(self.seed) & 0xFFFFFFFFFFFFFFFF,
                 int(step) & 0xFFFFFFFFFFFFFFFF]))

    def _full_masks(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """(drops, latency) at the ORIGINAL q — a fixed draw order keeps
        surviving links' streams invariant under :meth:`shrink`."""
        g = self._gen(step)
        drops = (g.random((self.q, self.q)) < self.drop_rate)
        spikes = (g.random((self.q, self.q)) < self.spike_rate)
        np.fill_diagonal(drops, False)
        np.fill_diagonal(spikes, False)
        lat = np.where(spikes, float(self.spike_factor), 1.0)
        return drops, lat

    def _select(self, m: np.ndarray) -> np.ndarray:
        a = np.asarray(self.alive_workers)
        return m[np.ix_(a, a)]

    def link_drops(self, step: int) -> np.ndarray:
        """``[q', q']`` 0/1 hard-drop mask (current numbering, diag 0)."""
        drops, _ = self._full_masks(step)
        return self._select(drops).astype(np.float32)

    def latency(self, step: int) -> np.ndarray:
        """``[q', q']`` per-link latency multipliers (≥ 1, diag 1)."""
        _, lat = self._full_masks(step)
        return self._select(lat).astype(np.float32)

    def effective_drops(self, step: int) -> np.ndarray:
        """Hard drops ∪ spikes past ``spike_threshold`` — the mask the
        degradation ladder consumes."""
        drops, lat = self._full_masks(step)
        eff = drops | (lat >= self.spike_threshold)
        return self._select(eff).astype(np.float32)

    def crash_at_step(self, step: int) -> int | None:
        """Index (CURRENT numbering) of a worker crashing at ``step``, or
        ``None``.  Events naming already-dead workers are ignored."""
        cur = self.alive_workers
        for s, w in self.crash_at:
            if int(s) == int(step) and int(w) in cur:
                return cur.index(int(w))
        return None

    def shrink(self, dead: int) -> "FaultSchedule":
        """The schedule after removing current-index ``dead`` — surviving
        pairs keep their exact fault streams."""
        cur = self.alive_workers
        if not 0 <= dead < len(cur):
            raise ValueError(f"dead index {dead} out of range for "
                             f"{len(cur)} live workers")
        alive = tuple(w for i, w in enumerate(cur) if i != dead)
        return dataclasses.replace(self, alive=alive)


# ---------------------------------------------------------------------------
# Degradation ladder: exchange → cached → backoff probe → local-only
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DegradeState:
    """Host-side per-pair ladder state (receiver × sender, all ``[Q,
    Q]`` int64): ``age`` counts consecutive steps without a fresh
    delivery, ``backoff`` the current probe backoff of dead pairs
    (0 = not in a dead episode), ``next_try`` the step of their next
    probe."""

    age: np.ndarray
    backoff: np.ndarray
    next_try: np.ndarray


def init_degrade(q: int) -> DegradeState:
    z = np.zeros((q, q), np.int64)
    return DegradeState(age=z.copy(), backoff=z.copy(), next_try=z.copy())


def degrade_plan(state: DegradeState, drops, step: int, *,
                 max_stale: int = 5, backoff_base: int = 1,
                 backoff_cap: int = 16
                 ) -> tuple[np.ndarray, DegradeState]:
    """One ladder transition: ``(serve [Q, Q] ∈ {FRESH, CACHED, DEAD},
    state')``.

    A pair with its link up serves FRESH (age resets) — unless it is in a
    dead episode, where the receiver only listens at probe steps (between
    probes even a recovered link stays DEAD; that is what gives the
    backoff real semantics).  A dropped pair serves the receiver's CACHED
    hop buffer while ``age < max_stale``; at the cap it goes DEAD: rows
    zeroed, local aggregation renormalised, and the link re-probed with
    exponential backoff ``backoff_base · 2^k`` capped at ``backoff_cap``.

    Pure in both arguments (the inputs are not mutated), so a crash-resume
    replays the exact ladder from a restored state.
    """
    if max_stale < 1:
        raise ValueError(f"max_stale must be >= 1, got {max_stale}")
    drops = np.asarray(drops) > 0.5
    np.fill_diagonal(drops, False)
    age, backoff, next_try = state.age, state.backoff, state.next_try
    in_dead = age >= max_stale
    # non-dead pairs always listen; dead pairs only when a probe is due
    # (backoff == 0 marks the first dead step of an episode)
    probe_due = ~in_dead | (backoff == 0) | (step >= next_try)
    fresh = ~drops & probe_due
    serve = np.where(fresh, FRESH, np.where(in_dead, DEAD, CACHED))
    new_age = np.where(fresh, 0, age + 1)
    probe_fail = in_dead & probe_due & drops
    new_backoff = np.where(
        fresh, 0,
        np.where(probe_fail,
                 np.clip(backoff * 2, backoff_base, backoff_cap), backoff))
    new_next = np.where(probe_fail, step + new_backoff, next_try)
    return serve.astype(np.int8), DegradeState(
        age=new_age.astype(np.int64), backoff=new_backoff.astype(np.int64),
        next_try=new_next.astype(np.int64))


def serve_masks(serve: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(fskip, dead)`` float32 0/1 masks of a serve plan — the fault
    channel operands of the aggregation oracles (``fskip`` substitutes
    the cached hop, ``dead`` zeroes it and triggers the local-only
    renormalisation; both charge zero wire bits in the ledger)."""
    return ((serve == CACHED).astype(np.float32),
            (serve == DEAD).astype(np.float32))


def migrate_degrade_state(state: DegradeState, dead: int) -> DegradeState:
    """Ladder state after worker ``dead`` leaves: delete its row/col."""
    def cut(m):
        return np.delete(np.delete(m, dead, axis=0), dead, axis=1)
    return DegradeState(age=cut(state.age), backoff=cut(state.backoff),
                        next_try=cut(state.next_try))


# ---------------------------------------------------------------------------
# Elastic shrink: ShardSet at Q - 1 + controller-state migration
# ---------------------------------------------------------------------------


def shrink_shards(shards, dead: int):
    """A :class:`repro_torch.graph.stream.ShardSet` with partition ``dead``
    removed — the elastic-Q path of a worker crash.

    Survivor partitions are renumbered (``p - (p > dead)``); remote edges
    sourced at the dead partition lose their weight (their contribution
    falls to the dead-pair renormalisation, not to stale junk), the rest
    have their flat halo indices remapped; the per-pair
    :class:`~repro_torch.dist.halo.HaloSpec` and p2p hop arrays are rebuilt for
    the smaller ring (ELL degrees — local edges — are untouched).
    Requires a fully-loaded set (every partition's remote table is needed
    to rebuild the pair sets).
    """
    from repro_torch.dist.halo import HaloSpec, build_halo_spec, halo_arrays
    from repro_torch.graph.stream import ShardSet

    if not isinstance(shards, ShardSet):
        raise TypeError("shrink_shards needs a loaded ShardSet (the "
                        "elastic path re-wires the halo around the dead "
                        "partition)")
    if tuple(shards.parts) != tuple(range(shards.q)):
        raise ValueError("shrink_shards needs all partitions loaded, got "
                         f"parts={shards.parts} of q={shards.q}")
    if not 0 <= dead < shards.q:
        raise ValueError(f"dead partition {dead} out of range [0, "
                         f"{shards.q})")
    if shards.q < 2:
        raise ValueError("cannot shrink below one worker")
    q_new = shards.q - 1
    keep = [p for p in range(shards.q) if p != dead]
    h_sz, p_sz = shards.halo_size, shards.part_size

    arrays = {k: np.array(v[keep]) for k, v in shards.arrays.items()}
    # remap remote edges: dead-sourced → weight 0 / dump row; survivors →
    # renumbered flat halo index (new_part * halo_size + slot)
    valid = arrays["remote_w"] > 0
    src_part = arrays["remote_src"] // h_sz
    slot = arrays["remote_src"] % h_sz
    from_dead = valid & (src_part == dead)
    new_part = src_part - (src_part > dead)
    alive = valid & ~from_dead
    arrays["remote_w"] = np.where(from_dead, 0.0,
                                  arrays["remote_w"]).astype(np.float32)
    arrays["remote_dst"] = np.where(from_dead, p_sz,
                                    arrays["remote_dst"]).astype(
        arrays["remote_dst"].dtype)
    arrays["remote_src"] = np.where(
        alive, new_part * h_sz + slot, 0).astype(arrays["remote_src"].dtype)

    new = ShardSet(
        path=shards.path, q=q_new, part_size=p_sz, halo_size=h_sz,
        num_nodes=shards.num_nodes, num_edges=shards.num_edges,
        feat_dim=shards.feat_dim, num_classes=shards.num_classes,
        halo_demand=0, cross_edges=int(alive.sum()),
        n_train=int(arrays["train_mask"].sum()),
        n_val=int(arrays["val_mask"].sum()),
        n_test=int(arrays["test_mask"].sum()),
        norm=shards.norm, name=f"{shards.name}-shrunk{dead}",
        halo_spec=None, parts=tuple(range(q_new)), arrays=arrays)
    # rebuild the per-pair halo layout for the smaller ring; local-edge
    # ELL arrays (and their padded degrees) are untouched by a crash
    spec = build_halo_spec(new)
    old = shards.halo_spec
    spec = HaloSpec(q=q_new, hop_width=spec.hop_width,
                    compact_rows=spec.compact_rows,
                    ell_degree=old.ell_degree, rev_degree=old.rev_degree,
                    pair_rows=spec.pair_rows)
    for k, v in halo_arrays(new, spec).items():
        arrays[k] = v
    object.__setattr__(new, "halo_spec", spec)
    object.__setattr__(new, "halo_demand",
                       int(np.asarray(spec.pair_rows).sum()))
    return new


def _cache_send_to_recv(c: torch.Tensor, q: int) -> torch.Tensor:
    """Sender-major hop cache ``[Q, D, H, F]`` (the emulated layout: row
    ``j``, hop ``d`` = what sender ``j`` ships at ring offset ``d``) ->
    receiver-major (row ``i``, hop ``d`` = what receiver ``i`` got from
    ``(i - d) mod Q``): the layout whose row ``i`` worker ``i`` of a
    group holds."""
    if q <= 1:
        return c
    i = torch.arange(q, device=c.device)[:, None]
    d = torch.arange(1, q, device=c.device)[None, :]
    return c[(i - d) % q, d - 1]


def _cache_recv_to_send(c: torch.Tensor, q: int) -> torch.Tensor:
    """Inverse of :func:`_cache_send_to_recv`."""
    if q <= 1:
        return c
    j = torch.arange(q, device=c.device)[:, None]
    d = torch.arange(1, q, device=c.device)[None, :]
    return c[(j + d) % q, d - 1]


def make_fault_train_step(cfg, policy, opt, meta, mesh=None,
                          sync: str = "grad"):
    """A train step with the fault channel threaded through — the
    degraded-mode analogue of ``make_auto_train_step`` that works under
    every communicating policy (full / fixed / varco / auto; scalar
    policies ride a uniform rate map).

    ``step(params, opt_state, graph, key, plan, fskip, dead, cache=(),
    fcache=()) -> (params, opt_state, metrics, cache', fcache')`` —
    ``fskip``/``dead`` are the ladder's ``[Q, Q]`` 0/1 masks
    (:func:`serve_masks`), ``fcache`` the fault hop cache
    (``repro_torch.dist.ratectl.init_halo_cache`` shapes, sender-major),
    and ``cache`` the stale-controller XOR error-feedback channel exactly
    as in the auto step.  When every pair quantises, the hops ride the
    fused sub-byte codec kernels, as the auto step's do.  Requires
    ``wire == 'p2p'``, ``Q >= 2`` and a communicating policy.

    With a worker ``mesh`` (``gnn_parallel.make_worker_mesh``) the step
    runs this worker's ``shard_graph`` block, as the JAX package's
    ``shard_map`` worker does: ``fcache`` holds this worker's ``[1, D, H,
    F]`` receiver-major blocks (row ``rank`` of
    :func:`_cache_send_to_recv`; ``init_halo_cache(..., mesh=mesh)``
    shapes), served on the receiver's side, and ``fcache'`` returns them
    alike; the loss and gradients are all-reduced (or FedAvg-averaged
    under ``sync="fedavg"``).  As in the JAX package the worker runs no
    error feedback (``cache`` passes through unchanged), ships quantised
    hops on the fp32 value path rather than sub-byte storage, and rounds
    them half to even; the stale controller's hop reuse raises
    ``ValueError``.

    Example::

        step = make_fault_train_step(cfg, policy, adamw(5e-3), meta)
        fskip, dead = serve_masks(serve)
        params, opt_state, m, cache, fcache = step(
            params, opt_state, graph, prng.key(t), plan, fskip, dead,
            cache, fcache)
    """
    from repro_torch.dist.gnn_parallel import (_F32, _local_loss_fn,
                                               _make_aggregate_emulated,
                                               _make_aggregate_shard,
                                               _packed_pair_k_for,
                                               _packed_store_w,
                                               _synced_update,
                                               _value_and_grad)
    from repro_torch.dist.ratectl.driver import (_auto_metrics,
                                                 exchange_widths,
                                                 plan_widths)
    from repro_torch.kernels.varco_pack import LANE

    if meta.wire != "p2p":
        raise ValueError("fault-tolerant training serves dropped links "
                         "from per-pair hop caches; it needs wire='p2p', "
                         f"got {meta.wire!r}")
    if meta.q < 2:
        raise ValueError("fault injection needs Q >= 2 (a single worker "
                         "has no links to drop)")
    if not policy.communicates:
        raise ValueError("fault injection needs a communicating policy "
                         "(the No-Comm baseline has no wire to fail)")
    if sync not in ("grad", "fedavg"):
        raise ValueError(f"sync must be 'grad' or 'fedavg', got {sync!r}")
    for f_ in {meta.feat_dim, *meta.layer_dims}:
        if f_ % LANE:
            raise ValueError(
                f"the fault channel rides the rate-map wire; every "
                f"exchanged width must be divisible by {LANE}, got {f_}")
    if mesh is not None and mesh.q != meta.q:
        raise ValueError(f"the mesh has {mesh.q} workers, the partitioning "
                         f"{meta.q}")
    q = meta.q
    n_ex = len(exchange_widths(cfg))
    auto = policy.mode == "auto"
    stale_ch = auto and policy.controller == "stale"
    if stale_ch and mesh is not None:
        raise ValueError("hop reuse is emulated-backend only; run the "
                         "stale controller with mesh=None")
    # error feedback and hop reuse share the cache channel: stale XOR EF
    use_ef = auto and policy.max_width < 32 and not stale_ch and \
        mesh is None

    def step(params, opt_state, graph, key, plan, fskip, dead, cache=(),
             fcache=()):
        if len(fcache) != n_ex:
            raise ValueError(f"fcache must hold one buffer per exchange "
                             f"call ({n_ex}), got {len(fcache)} — pass "
                             f"init_halo_cache(meta, cfg)")
        rm = np.asarray(plan.rates, np.float32)
        kb = dict(_packed_pair_k_for(meta, rm))
        wm = plan_widths(meta, plan)
        rate_s = 1.0
        if policy.mode == "varco":
            rate_s = float(rm[~np.eye(q, dtype=bool)].mean())
        ef = use_ef and wm is not None and bool(cache)
        fcache = tuple(fcache)
        cache_out: list = []
        fcache_out: list = []
        rate_t = torch.tensor(rate_s, dtype=_F32)

        def loss_fn(p):
            if mesh is not None:
                agg = _make_aggregate_shard(
                    graph, meta, policy, rate_t, key, mesh, packed_k=kb,
                    rate_map=rm, width_map=wm, fskip=fskip, fcache=fcache,
                    fcache_out=fcache_out, dead=dead)
            else:
                agg = _make_aggregate_emulated(
                    graph, meta, policy, rate_t, key, packed_k=kb,
                    rate_map=rm, width_map=wm,
                    skip=np.asarray(plan.skip, np.float32) if stale_ch
                    else None,
                    cache=cache if stale_ch else None,
                    cache_out=cache_out if stale_ch else None,
                    resid=cache if ef else None,
                    resid_out=cache_out if ef else None,
                    store_w=_packed_store_w(meta, wm),
                    fskip=fskip, fcache=fcache, fcache_out=fcache_out,
                    dead=dead)
            return _local_loss_fn(p, cfg, graph, agg, meta)

        (loss, bits), grads = _value_and_grad(loss_fn, params)
        loss, new_params, new_state = _synced_update(
            opt, loss, grads, opt_state, params, mesh, sync)
        with span("sync.step_metrics"):
            bits = bits.detach().cpu()
        metrics = _auto_metrics(loss, rm, bits, q, n_ex)
        # an exact step carries the EF residuals unchanged
        return new_params, new_state, metrics, \
            tuple(cache_out) if cache_out else tuple(cache), \
            tuple(fcache_out)

    return step


def migrate_controller_state(state: dict, dead: int, q: int) -> dict:
    """Controller state after worker ``dead`` (of ``q``) leaves.

    Pair-shaped leaves (trailing ``[Q, Q]``: the error controller's
    ``ema``/``y``, the stale controller's ``age``/``skip``, the qos
    controller's pair EMAs) lose the dead row/column; scalar and
    per-layer leaves (budget ``spent``/``integ``, ``[L]`` EMAs) carry
    over unchanged — the PI loop then re-spends the dead link's bits on
    the surviving pairs.
    """
    keep = torch.as_tensor([i for i in range(q) if i != dead])
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor) and v.dim() >= 2 and \
                tuple(v.shape[-2:]) == (q, q):
            idx = keep.to(v.device)
            v = v.index_select(-2, idx).index_select(-1, idx)
        out[k] = v
    return out
