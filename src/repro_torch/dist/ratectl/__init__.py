"""Closed-loop rate control for the p2p and packed wires: the controller
API, budget pacing, the ``budget``, ``error``, ``stale`` and ``qos``
controllers, the per-pair train step and the shared drift gate."""

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
from repro_torch.dist.ratectl.error import error_controller
from repro_torch.dist.ratectl.qos import qos_controller
from repro_torch.dist.ratectl.stale import drift_skip, stale_controller

__all__ = [
    "CONTROLLERS", "Pacing", "RateController", "RatePlan", "allowance",
    "best_uniform_width", "make_pacing", "rate_of_allowance",
    "refine_widths", "sustainable_cap", "uniform_layer_plan",
    "uniform_plan", "waterfill", "width_candidates", "width_cost",
    "width_eps", "widths_map", "budget_controller", "exchange_widths",
    "init_halo_cache", "init_wire_residuals", "layer_exchange_widths",
    "make_auto_train_step", "make_controller", "qos_controller",
    "drift_skip", "error_controller", "stale_controller",
]
