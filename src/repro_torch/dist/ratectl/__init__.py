"""Closed-loop rate control for the p2p wire: the controller API, budget
pacing, the ``qos`` controller and the shared drift gate."""

from repro_torch.dist.ratectl.base import (CONTROLLERS, Pacing,
                                           RateController, RatePlan,
                                           allowance, make_pacing,
                                           refine_widths, waterfill,
                                           width_candidates, width_cost,
                                           width_eps)
from repro_torch.dist.ratectl.driver import (exchange_widths,
                                             init_halo_cache,
                                             make_controller)
from repro_torch.dist.ratectl.qos import qos_controller
from repro_torch.dist.ratectl.stale import drift_skip

__all__ = [
    "CONTROLLERS", "Pacing", "RateController", "RatePlan", "allowance",
    "make_pacing", "refine_widths", "waterfill", "width_candidates",
    "width_cost", "width_eps", "exchange_widths", "init_halo_cache",
    "make_controller", "qos_controller", "drift_skip",
]
