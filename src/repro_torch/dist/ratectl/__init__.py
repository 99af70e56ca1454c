"""Closed-loop rate control for the p2p wire: the controller API, budget
pacing, the ``budget`` and ``qos`` controllers, the per-pair train step
and the shared drift gate."""

from repro_torch.dist.ratectl.base import (CONTROLLERS, Pacing,
                                           RateController, RatePlan,
                                           allowance, best_uniform_width,
                                           make_pacing, rate_of_allowance,
                                           refine_widths, sustainable_cap,
                                           uniform_layer_plan, uniform_plan,
                                           waterfill, width_candidates,
                                           width_cost, width_eps, widths_map)
from repro_torch.dist.ratectl.budget import budget_controller
from repro_torch.dist.ratectl.driver import (exchange_widths,
                                             init_halo_cache,
                                             init_wire_residuals,
                                             layer_exchange_widths,
                                             make_auto_train_step,
                                             make_controller)
from repro_torch.dist.ratectl.qos import qos_controller
from repro_torch.dist.ratectl.stale import drift_skip

__all__ = [
    "CONTROLLERS", "Pacing", "RateController", "RatePlan", "allowance",
    "best_uniform_width", "make_pacing", "rate_of_allowance",
    "refine_widths", "sustainable_cap", "uniform_layer_plan",
    "uniform_plan", "waterfill", "width_candidates", "width_cost",
    "width_eps", "widths_map", "budget_controller", "exchange_widths",
    "init_halo_cache", "init_wire_residuals", "layer_exchange_widths",
    "make_auto_train_step", "make_controller", "qos_controller",
    "drift_skip",
]
