"""Trainer integration: auto policies → controller + per-pair train step.

Counterpart of ``repro/dist/ratectl/driver.py`` (emulated backend):

* :func:`make_controller` — instantiate the named controller (``budget``
  or ``qos``) with the shared budget pacing;
* :func:`make_auto_train_step` — the per-pair-rate Algorithm-1 step: the
  compression operand is a host ``[Q, Q]`` (or per-layer ``[L, Q, Q]``)
  rate map and optional width map planned by the controller each step;
* :func:`init_halo_cache` / :func:`init_wire_residuals` — the per-exchange
  buffers the cache channel carries (serving's hop cache, training's
  error-feedback residuals).

The loop a trainer runs (``repro_torch.train.trainer.train_gnn``)::

    ctl = make_controller(policy, meta, cfg, total_steps)
    state, cache = ctl.init(), init_wire_residuals(meta, cfg)
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
from repro_torch.dist.gnn_parallel import (DistMeta, _make_aggregate_emulated,
                                           _optimize, _packed_pair_k_for,
                                           _packed_pair_w_for, _packed_store_w,
                                           _per, _snap_width, _value_and_grad)
from repro_torch.dist.ratectl.base import RateController, RatePlan, make_pacing
from repro_torch.dist.ratectl.budget import budget_controller
from repro_torch.dist.ratectl.qos import qos_controller
from repro_torch.kernels.varco_pack import LANE
from repro_torch.nn.gnn import GNNConfig, gnn_forward, masked_loss_and_correct

_F32 = torch.float32


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
    :func:`make_pacing` (``c_max``, ``slope``, ``kp``, ``ki``, ...) and
    ``ema_decay`` to the controller."""
    if policy.mode != "auto":
        raise ValueError(f"policy mode must be 'auto', got {policy.mode!r}")
    if policy.controller not in ("budget", "qos"):
        raise NotImplementedError(
            f"the {policy.controller!r} controller is not ported yet "
            f"(ROADMAP queue 1: rate control); the port runs 'budget' and "
            f"'qos'")
    ctl_kw = {k: overrides.pop(k) for k in ("ema_decay",) if k in overrides}
    pacing = make_pacing(meta, exchange_widths(cfg), total_steps,
                         policy.budget_bits,
                         layer_widths=layer_exchange_widths(cfg)
                         if policy.per_layer else None, **overrides)
    if policy.controller == "budget":
        return budget_controller(meta.q, pacing, per_layer=policy.per_layer,
                                 max_width=policy.max_width, **ctl_kw)
    return qos_controller(meta.q, pacing, meta.pair_table(),
                          per_layer=policy.per_layer,
                          max_width=policy.max_width, **ctl_kw)


def init_halo_cache(meta, cfg, device="cuda") -> tuple:
    """Zero-initialised per-exchange hop buffers (``[Q, D, H, width]``
    per exchange call; p2p wire).  Serving's drift-gated hop cache never
    reads them before the first refresh fills them."""
    d = max(meta.q - 1, 1)
    return tuple(torch.zeros((meta.q, d, meta.p2p_hop_width, w),
                             dtype=_F32, device=device)
                 for w in exchange_widths(cfg))


def init_wire_residuals(meta, cfg, device="cuda") -> tuple:
    """Zero-initialised error-feedback residuals for quantising policies
    (``max_width < 32``): one full-width ``[Q, D, H, width]`` buffer per
    exchange call, the same shapes as :func:`init_halo_cache`.  Each step
    the residual is added to the pre-quantisation rows and replaced by
    the new quantisation error, so the wire's rounding error is re-shipped
    instead of lost."""
    return init_halo_cache(meta, cfg, device)


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
    the storage grid, and when every pair quantises the hops ride the
    fused sub-byte kernels at the maximum snapped width.  ``cache`` is the
    error-feedback residual tuple (:func:`init_wire_residuals`) for a
    quantising policy, else ``()``; an exact step carries it unchanged.
    ``metrics`` adds ``pair_transport`` / ``pair_err`` / ``pair_delta``
    ``[Q, Q]`` to the usual scalars.  Rounding is round-to-nearest-even
    (the JAX package's default off the TPU)."""
    if policy.mode != "auto":
        raise ValueError(f"make_auto_train_step needs an 'auto' policy, "
                         f"got mode {policy.mode!r}")
    if mesh is not None:
        raise NotImplementedError(
            "the shard_map backend is not ported (ROADMAP queue 1)")
    if meta.wire == "packed":
        raise NotImplementedError(
            "auto policies on the packed wire (per-sender rate and width "
            "maps) are not ported yet (ROADMAP queue 1: auto policies on "
            "the packed wire); use wire='p2p'")
    if meta.wire != "p2p":
        raise ValueError(f"per-pair rate maps need wire='p2p', got "
                         f"{meta.wire!r}")
    if sync not in ("grad", "fedavg"):
        raise ValueError(f"sync must be 'grad' or 'fedavg', got {sync!r}")
    stale = (policy.controller == "stale") if stale is None else stale
    if stale:
        raise NotImplementedError(
            "training hop reuse (the stale controller) is not ported yet "
            "(ROADMAP queue 1: rate control)")
    if rounding not in (None, "rint"):
        raise NotImplementedError(
            f"rounding {rounding!r} is not ported (ROADMAP queue 1): the "
            f"port rounds half to even ('rint')")
    for f_ in {meta.feat_dim, *meta.layer_dims}:
        if f_ % LANE:
            raise ValueError(
                f"per-pair rate maps pack lane-blocks; every exchanged "
                f"width must be divisible by {LANE}, got {f_}")
    n_ex = len(exchange_widths(cfg))
    use_ef = policy.max_width < 32

    def plan_widths(plan: RatePlan):
        """Snap the planned widths to the storage grid; ``None`` when no
        pair quantises."""
        if plan.widths is None:
            return None
        wm = np.vectorize(_snap_width)(
            np.asarray(plan.widths, np.float32)).astype(np.float32)
        return wm if _packed_pair_w_for(meta, wm) else None

    def step(params, opt_state, graph, key, plan: RatePlan, cache=()):
        rm = np.asarray(plan.rates, np.float32)
        kb = dict(_packed_pair_k_for(meta, rm))
        wm = plan_widths(plan)
        ef = use_ef and wm is not None and bool(cache)
        cache_out: list = []

        def loss_fn(p):
            agg = _make_aggregate_emulated(
                graph, meta, policy, torch.ones((), dtype=_F32), key,
                packed_k=kb, rate_map=rm, width_map=wm,
                resid=cache if ef else None,
                resid_out=cache_out if ef else None,
                store_w=_packed_store_w(meta, wm))
            logits, bits = gnn_forward(p, cfg, graph["features"], agg)
            loss_sum, _ = masked_loss_and_correct(
                logits, graph["labels"], graph["train_mask"])
            return loss_sum * _per(meta.n_train), bits

        (loss, bits), grads = _value_and_grad(loss_fn, params)
        new_params, new_state = _optimize(opt, grads, opt_state, params)
        metrics = _auto_metrics(loss, rm, bits.detach().cpu(), meta.q, n_ex)
        return new_params, new_state, metrics, \
            tuple(cache_out) if ef else tuple(cache)

    return step
