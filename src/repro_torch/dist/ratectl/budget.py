"""``budget`` controller: PI tracking of transport bits against a budget.

Counterpart of ``repro/dist/ratectl/budget.py``.  The user names a total
wire budget ``B`` (bits over the run); each step the controller plans ONE
uniform rate whose predicted transport follows the paper's eq.-(8)
reference trajectory scaled to ``B``, and closes the loop with PI
feedback on the measured cumulative transport.  ``max_width < 32`` first
picks the single wire width whose cheaper bits retain the most signal
(:func:`~repro_torch.dist.ratectl.base.best_uniform_width`), then turns
the allowance at that width's cost into the rate.  ``per_layer=True``
water-fills each step's allowance over the layers by their measured
dropped energy, monotone per layer.  State is float32 CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.dist.ratectl.base import (Pacing, RateController, allowance,
                                           best_uniform_width,
                                           fold_layer_err, init_layer_fill,
                                           plan_layer_fill,
                                           rate_of_allowance,
                                           uniform_layer_plan, uniform_plan,
                                           width_candidates, widths_map)

__all__ = ["budget_controller"]


def budget_controller(q: int, pacing: Pacing, name: str = "budget",
                      per_layer: bool = False, ema_decay: float = 0.8,
                      max_width: int = 32) -> RateController:
    """Budget-tracking PI controller over ``q`` workers.  State:
    ``{"spent", "integ"}``; the per-layer mode adds ``{"ema", "y"}`` and
    needs ``pacing.layer_bits``."""
    if per_layer and pacing.layer_bits is None:
        raise ValueError(
            "per_layer needs pacing.layer_bits — build the pacing with "
            "make_pacing(..., layer_widths=layer_exchange_widths(cfg))")
    candidates = width_candidates(max_width)

    def init():
        state = {"spent": torch.zeros((), dtype=torch.float32),
                 "integ": torch.zeros((), dtype=torch.float32)}
        if per_layer:
            state.update(init_layer_fill(pacing))
        return state

    def pick_width(state, step):
        """The step's uniform width from the PI allowance (32: exact)."""
        if len(candidates) == 1:               # width axis off
            return None, 1.0
        bits, _ = allowance(pacing, state["spent"], state["integ"], step)
        return best_uniform_width(bits, pacing.d_full, candidates)

    def plan(state, step):
        w_star, cost = pick_width(state, step)
        wmap = None if w_star is None else widths_map(q, w_star)
        if not per_layer:
            bits, integ = allowance(pacing, state["spent"], state["integ"],
                                    step)
            plan_ = uniform_plan(q, rate_of_allowance(pacing, bits / cost))
            return plan_._replace(widths=wmap), {**state, "integ": integ}
        rates_l, integ, y = plan_layer_fill(pacing, state, step,
                                            cost_factor=cost)
        plan_ = uniform_layer_plan(q, rates_l)
        return plan_._replace(widths=wmap), \
            {**state, "integ": integ, "y": y}

    def observe(state, obs):
        out = {**state,
               "spent": state["spent"] +
               torch.as_tensor(obs["transport_bits"], dtype=torch.float32)}
        if per_layer:
            out.update(fold_layer_err(state, obs, ema_decay))
        return out

    return RateController(name, init, observe, plan)
