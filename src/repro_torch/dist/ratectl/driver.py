"""Trainer integration: auto policies → controller + per-pair train step.

Counterpart of ``repro/dist/ratectl/driver.py``, on both backends:

* :func:`make_controller` — instantiate the named controller (``budget``,
  ``error``, ``stale`` or ``qos``) with the shared budget pacing;
* :func:`make_auto_train_step` — the per-pair-rate Algorithm-1 step on
  the p2p or packed wire: the compression operand is a host ``[Q, Q]``
  (or per-layer ``[L, Q, Q]``) rate map, optional width map and skip
  mask planned by the controller each step; emulated, or with ``mesh=``
  one worker of a process group;
* :func:`init_halo_cache` / :func:`init_wire_residuals` — the per-exchange
  buffers the cache channel carries (the ``stale`` controller's and
  serving's hop cache, or the error-feedback residuals of a quantising
  p2p policy: stale XOR error feedback).

The loop a trainer runs (``repro_torch.train.trainer.train_gnn``)::

    ctl = make_controller(policy, meta, cfg, total_steps)
    state, cache = ctl.init(), init_halo_cache(meta, cfg)  # under stale
    step = make_auto_train_step(cfg, policy, opt, meta)
    for t in range(total_steps):
        plan, state = ctl.plan(state, t)
        params, opt_state, m, cache = step(params, opt_state, graph,
                                           prng.key(t), plan, cache)
        state = ctl.observe(state, m)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.varco import CommPolicy
from repro_torch.dist.gnn_parallel import (DistMeta, _local_loss_fn,
                                           _make_aggregate_emulated,
                                           _make_aggregate_shard,
                                           _packed_pair_k_for,
                                           _packed_pair_w_for, _packed_store_w,
                                           _per, _snap_width, _synced_update,
                                           _value_and_grad)
from repro_torch.dist.ratectl.base import RateController, RatePlan, make_pacing
from repro_torch.dist.ratectl.budget import budget_controller
from repro_torch.dist.ratectl.error import error_controller
from repro_torch.dist.ratectl.qos import qos_controller
from repro_torch.dist.ratectl.stale import stale_controller
from repro_torch.kernels.ops import default_wire_rounding
from repro_torch.kernels.varco_pack import LANE
from repro_torch.nn.gnn import GNNConfig
from repro_torch.spans import span

_F32 = torch.float32
#: the JAX package's reason for refusing the stale controller on a mesh
STALE_ON_MESH = ("hop reuse is emulated-backend only: a shape-uniform SPMD "
                 "ppermute cannot drop individual pairs' buffers (DESIGN.md "
                 "§3.6); run the stale controller with mesh=None")


def exchange_widths(cfg) -> tuple[int, ...]:
    """Feature width of every halo exchange in one forward pass: each
    layer's input width, once per exchange call (sage: one per layer;
    poly: ``k_taps - 1`` per layer)."""
    dims = [cfg.in_dim] + [cfg.hidden] * (cfg.layers - 1)
    reps = 1 if cfg.conv == "sage" else max(cfg.k_taps - 1, 1)
    return tuple(d for d in dims for _ in range(reps))


def layer_exchange_widths(cfg) -> tuple[int, ...]:
    """Summed exchange width of each model layer (``[L]``); sums to
    ``sum(exchange_widths(cfg))``."""
    dims = [cfg.in_dim] + [cfg.hidden] * (cfg.layers - 1)
    reps = 1 if cfg.conv == "sage" else max(cfg.k_taps - 1, 1)
    return tuple(d * reps for d in dims)


def make_controller(policy: CommPolicy, meta, cfg, total_steps: int,
                    **overrides) -> RateController:
    """Instantiate ``policy.controller`` with pacing scaled to
    ``policy.budget_bits`` over ``total_steps``.  ``overrides`` pass to
    :func:`make_pacing` (``c_max``, ``slope``, ``kp``, ``ki``, ...) and to
    the controller (``threshold``/``max_stale`` for ``stale``,
    ``ema_decay`` for ``error``/``qos`` and the per-layer modes)."""
    if policy.mode != "auto":
        raise ValueError(f"policy mode must be 'auto', got {policy.mode!r}")
    ctl_kw = {k: overrides.pop(k) for k in ("threshold", "max_stale",
                                            "ema_decay") if k in overrides}
    per_layer = policy.per_layer
    pacing = make_pacing(meta, exchange_widths(cfg), total_steps,
                         policy.budget_bits,
                         layer_widths=layer_exchange_widths(cfg)
                         if per_layer else None, **overrides)
    if policy.controller != "stale":
        bad = sorted(k for k in ("threshold", "max_stale") if k in ctl_kw)
        if bad:
            raise ValueError(
                f"{'/'.join(bad)} are stale-controller knobs; the "
                f"{policy.controller!r} controller does not accept them")
    if "ema_decay" in ctl_kw and policy.controller not in ("error", "qos") \
            and not per_layer:
        raise ValueError(
            f"ema_decay drives the error/qos EMAs; the scalar "
            f"{policy.controller!r} controller keeps none — use the error "
            f"or qos controller or a :per-layer policy")
    kw = dict(per_layer=per_layer, max_width=policy.max_width, **ctl_kw)
    if policy.controller == "budget":
        return budget_controller(meta.q, pacing, **kw)
    if policy.controller == "error":
        return error_controller(meta.q, pacing, meta.pair_table(), **kw)
    if policy.controller == "qos":
        return qos_controller(meta.q, pacing, meta.pair_table(), **kw)
    if policy.controller == "stale":
        return stale_controller(meta.q, pacing, **kw)
    raise ValueError(f"unknown controller {policy.controller!r}")


def init_halo_cache(meta, cfg, device="cuda", mesh=None) -> tuple:
    """Zero-initialised per-exchange hop buffers (``[Q, D, H, width]``
    per exchange call; p2p wire) for the ``stale`` controller and
    serving's drift-gated hop cache.  Neither skips before the first
    exchange fills them, so the zeros are never read; the fault channel
    (``repro_torch.dist.faults``) keeps its hop cache in the same shapes.
    The emulated buffers are sender-major: row ``j``, hop ``d`` is what
    worker ``j`` ships at ring offset ``d``.  With a worker ``mesh`` each
    buffer is this worker's ``[1, D, H, width]`` block: its own sent hops
    (the sender-major row ``rank``) for the error-feedback residuals of
    :func:`init_wire_residuals`, the hops it received (hop ``d`` from
    worker ``(rank - d) mod Q``: row ``rank`` of ``faults.
    _cache_send_to_recv``) for the fault cache."""
    d = max(meta.q - 1, 1)
    rows = meta.q if mesh is None else 1
    return tuple(torch.zeros((rows, d, meta.p2p_hop_width, w), dtype=_F32,
                             device=device)
                 for w in exchange_widths(cfg))


def init_wire_residuals(meta, cfg, device="cuda", mesh=None) -> tuple:
    """Zero-initialised error-feedback residuals for quantising policies
    on the p2p wire (``max_width < 32``, never under ``stale``): one
    full-width ``[Q, D, H, width]`` buffer per exchange call (a worker's
    ``[1, D, H, width]`` slab with ``mesh``), the same shapes as
    :func:`init_halo_cache`.  Each step the residual is added to the
    pre-quantisation rows and replaced by the new quantisation error, so
    the wire's rounding error is re-shipped instead of lost."""
    return init_halo_cache(meta, cfg, device, mesh)


def plan_widths(meta, plan: RatePlan):
    """A plan's widths snapped to the storage grid (host ``[Q, Q]`` or
    ``[L, Q, Q]`` float32); ``None`` when no pair quantises."""
    if plan.widths is None:
        return None
    wm = np.vectorize(_snap_width)(
        np.asarray(plan.widths, np.float32)).astype(np.float32)
    return wm if _packed_pair_w_for(meta, wm) else None


def _auto_metrics(loss, rate_map: np.ndarray, bits: torch.Tensor, q: int,
                  n_exchanges: int) -> dict:
    """Step metrics of the per-pair ledger vector (``2 + 3·L·Q²``);
    transports double for the backward cotangents, the staleness delta is
    averaged over the exchange calls, and a per-layer plan adds
    ``layer_transport`` / ``layer_err`` ``[L, Q, Q]``."""
    rm = torch.as_tensor(rate_map, dtype=_F32)
    n_layers = 1 if rm.dim() == 2 else rm.shape[0]
    off = ~torch.eye(q, dtype=torch.bool)
    mean_rate = torch.where(off, rm, torch.zeros((), dtype=_F32)).sum() * \
        _per((q * q - q) * n_layers)
    lq2 = n_layers * q * q
    layer_t = bits[2:2 + lq2].reshape(n_layers, q, q)
    layer_e = bits[2 + lq2:2 + 2 * lq2].reshape(n_layers, q, q)
    layer_d = bits[2 + 2 * lq2:2 + 3 * lq2].reshape(n_layers, q, q)
    out = {"loss": loss, "rate": mean_rate,
           "halo_bits": 2.0 * bits[0], "transport_bits": 2.0 * bits[1],
           "pair_transport": 2.0 * layer_t.sum(0),
           "pair_err": layer_e.sum(0),
           "pair_delta": layer_d.sum(0) * _per(n_exchanges)}
    if rm.dim() == 3:
        out["layer_transport"] = 2.0 * layer_t
        out["layer_err"] = layer_e
    return out


def make_auto_train_step(cfg: GNNConfig, policy: CommPolicy, opt, meta:
                         DistMeta, mesh=None, sync: str = "grad",
                         stale: bool | None = None,
                         rounding: str | None = None):
    """One Algorithm-1 step driven by a :class:`RatePlan`.

    ``step(params, opt_state, graph, key, plan, cache=()) -> (params,
    opt_state, metrics, cache')``: ``plan.rates`` is a host ``[Q, Q]`` map
    or per-layer ``[L, Q, Q]`` tensor, quantised to the static kept-block
    maximum per width; ``plan.widths`` (``None`` or a map) is snapped to
    the storage grid, and when every pair quantises the wire rides the
    fused sub-byte kernels at the maximum snapped width.  ``meta.wire`` is
    ``"p2p"`` or ``"packed"`` (one payload per sender: the maximum of its
    receivers' kept counts and widths).  ``cache`` is the ``stale``
    controller's halo cache (:func:`init_halo_cache`; ``plan.skip`` marks
    the pairs served from it, p2p only), or on the p2p wire the
    error-feedback residuals (:func:`init_wire_residuals`) of a
    quantising policy — stale XOR error feedback — else ``()``; an exact
    step carries residuals unchanged.  ``metrics`` adds ``pair_transport``
    / ``pair_err`` / ``pair_delta`` ``[Q, Q]`` to the usual scalars.
    ``rounding`` is ``"rint"`` (round half to even) or ``"stochastic"``
    (``floor(v + u)`` under the per-pair ``round_key`` stream); ``None``
    picks by the device each step runs on (``ops.
    default_wire_rounding``): stochastic on the card, rint on the CPU.

    With a worker ``mesh`` (``gnn_parallel.make_worker_mesh``) the step
    runs this worker's ``shard_graph`` block over the group's collectives,
    its ``cache`` this worker's ``[1, D, H, F]`` residual slabs
    (``init_wire_residuals(..., mesh=mesh)``): the loss all-reduced, and
    the gradients too under ``sync="grad"``, or under ``"fedavg"`` a local
    update and the mean of the floating parameters and optimiser state.
    Every worker's ledger, and so its metrics, are the same bytes, and a
    controller fed them plans alike on every worker.  The stale
    controller's hop reuse raises ``ValueError`` there, as in the JAX
    package."""
    if policy.mode != "auto":
        raise ValueError(f"make_auto_train_step needs an 'auto' policy, "
                         f"got mode {policy.mode!r}")
    if meta.wire not in ("packed", "p2p"):
        raise ValueError(f"per-pair rate maps need wire='packed' or 'p2p', "
                         f"got {meta.wire!r} (the dense wire is "
                         f"scalar-only)")
    if sync not in ("grad", "fedavg"):
        raise ValueError(f"sync must be 'grad' or 'fedavg', got {sync!r}")
    for f_ in {meta.feat_dim, *meta.layer_dims}:
        if f_ % LANE:
            raise ValueError(
                f"per-pair rate maps pack lane-blocks; every exchanged "
                f"width must be divisible by {LANE}, got {f_}")
    n_ex = len(exchange_widths(cfg))
    stale = (policy.controller == "stale") if stale is None else stale
    if stale and meta.wire != "p2p":
        raise ValueError("the stale controller reuses per-pair hop buffers; "
                         "it needs wire='p2p'")
    if stale and mesh is not None:
        raise ValueError(STALE_ON_MESH)
    if mesh is not None and mesh.q != meta.q:
        raise ValueError(f"the mesh has {mesh.q} workers, the partitioning "
                         f"{meta.q}")
    if rounding not in (None, "rint", "stochastic"):
        raise ValueError(f"rounding must be 'rint' or 'stochastic', "
                         f"got {rounding!r}")
    # error feedback and hop reuse share the cache channel: stale XOR EF
    use_ef = policy.max_width < 32 and meta.wire == "p2p" and not stale

    def step(params, opt_state, graph, key, plan: RatePlan, cache=()):
        mode = rounding or default_wire_rounding(graph["features"].device)
        rm = np.asarray(plan.rates, np.float32)
        kb = dict(_packed_pair_k_for(meta, rm))
        wm = plan_widths(meta, plan)
        ef = use_ef and wm is not None and bool(cache)
        cache_out: list = []
        kw = dict(packed_k=kb, rate_map=rm, width_map=wm,
                  resid=cache if ef else None,
                  resid_out=cache_out if ef else None,
                  store_w=_packed_store_w(meta, wm), rounding=mode)
        one = torch.ones((), dtype=_F32)

        def loss_fn(p):
            if mesh is None:
                agg = _make_aggregate_emulated(
                    graph, meta, policy, one, key,
                    skip=np.asarray(plan.skip, np.float32) if stale
                    else None, cache=cache if stale else None,
                    cache_out=cache_out if stale else None, **kw)
            else:
                agg = _make_aggregate_shard(graph, meta, policy, one, key,
                                            mesh, **kw)
            return _local_loss_fn(p, cfg, graph, agg, meta)

        (loss, bits), grads = _value_and_grad(loss_fn, params)
        loss, new_params, new_state = _synced_update(
            opt, loss, grads, opt_state, params, mesh, sync)
        with span("sync.step_metrics"):
            bits = bits.detach().cpu()
        metrics = _auto_metrics(loss, rm, bits, meta.q, n_ex)
        return new_params, new_state, metrics, \
            tuple(cache_out) if cache_out else tuple(cache)

    return step
