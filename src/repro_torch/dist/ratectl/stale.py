"""``stale`` controller: skip unchanged pairs' hops, reuse cached halos.

Counterpart of ``repro/dist/ratectl/stale.py``.  The controller runs the
``budget`` controller's PI-paced uniform rate for the pairs that do
communicate, and skips pair ``(i, j)``'s hop whenever its measured
relative change ``‖fresh − cached‖² / ‖fresh‖²`` stayed at or below
``threshold`` — for at most ``max_stale`` consecutive steps, so no halo
row is ever older than that.  Skipped pairs charge zero wire bits
(forward and backward) and the PI loop re-spends the saved bits on the
refreshing pairs.  Hop reuse runs on the p2p wire.

``per_layer=True`` runs the communicating pairs at per-layer rates (the
``budget`` controller's water-fill over layers); ``max_width < 32`` runs
every communicating pair's wire at that width, flat (hop reuse keys its
state off the exchange cache, so the width axis stays static).

:func:`drift_skip`, the gating predicate, is shared with serving's
drift-gated cache invalidation (``repro_torch.serve``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.ratectl.base import (Pacing, RateController, RatePlan,
                                           allowance, fold_layer_err,
                                           init_layer_fill, plan_layer_fill,
                                           rate_of_allowance,
                                           uniform_layer_plan, width_cost,
                                           widths_map)

__all__ = ["drift_skip", "stale_controller"]

_F32 = torch.float32


def drift_skip(delta, age, threshold: float, max_stale: int) -> np.ndarray:
    """Pair ``(i, j)`` may be served from cache (skip == 1) iff its
    measured relative drift ``delta[i, j] = ‖fresh − cached‖² / ‖fresh‖²``
    is at or below ``threshold`` AND it has been reused fewer than
    ``max_stale`` consecutive times (``age``).  The diagonal never skips.
    Compared in float32, as the JAX package does.  Returns the ``[Q, Q]``
    float32 0/1 mask."""
    delta = np.asarray(delta, np.float32)
    age = np.asarray(age, np.float32)
    eye = np.eye(delta.shape[-1], dtype=bool)
    return ((delta <= np.float32(threshold)) &
            (age < np.float32(max_stale)) & ~eye).astype(np.float32)


def stale_controller(q: int, pacing: Pacing, threshold: float = 0.05,
                     max_stale: int = 5, name: str = "stale",
                     per_layer: bool = False, ema_decay: float = 0.8,
                     max_width: int = 32) -> RateController:
    """Staleness-reuse controller.  State: ``{"spent", "integ", "age"
    [Q, Q] consecutive reuses, "skip" [Q, Q] next step's skip mask}``
    (float32 CPU tensors); ``per_layer=True`` adds the ``budget``
    controller's ``{"ema", "y"}`` over ``[L]`` and needs
    ``pacing.layer_bits``.  ``observe`` needs ``pair_delta``."""
    if per_layer and pacing.layer_bits is None:
        raise ValueError(
            "per_layer needs pacing.layer_bits — build the pacing with "
            "make_pacing(..., layer_widths=layer_exchange_widths(cfg))")
    eye = torch.eye(q, dtype=torch.bool)
    wmap = None if max_width >= 32 else widths_map(q, float(max_width))
    w_cost = width_cost(max_width)

    def init():
        state = {"spent": torch.zeros((), dtype=_F32),
                 "integ": torch.zeros((), dtype=_F32),
                 "age": torch.zeros((q, q), dtype=_F32),
                 "skip": torch.zeros((q, q), dtype=_F32)}
        if per_layer:
            state.update(init_layer_fill(pacing))
        return state

    def plan(state, step):
        if not per_layer:
            bits, integ = allowance(pacing, state["spent"], state["integ"],
                                    step)
            rate = rate_of_allowance(
                pacing, bits / torch.tensor(w_cost, dtype=_F32))
            rates = torch.where(eye, torch.tensor(1.0), rate)
            return RatePlan(rates, state["skip"], wmap), \
                {**state, "integ": integ}
        rates_l, integ, y = plan_layer_fill(pacing, state, step,
                                            cost_factor=w_cost)
        plan_ = uniform_layer_plan(q, rates_l)
        return RatePlan(plan_.rates, state["skip"], wmap), \
            {**state, "integ": integ, "y": y}

    def observe(state, obs):
        # pairs served stale this step aged by one; refreshed pairs reset
        age = torch.where(state["skip"] > 0.0, state["age"] + 1.0,
                          torch.tensor(0.0))
        skip = torch.from_numpy(drift_skip(obs["pair_delta"], age.numpy(),
                                           threshold, max_stale))
        out = {**state, "age": age, "skip": skip,
               "spent": state["spent"] +
               torch.as_tensor(obs["transport_bits"], dtype=_F32)}
        if per_layer:
            out.update(fold_layer_err(state, obs, ema_decay))
        return out

    return RateController(name, init, observe, plan)
