"""``qos`` controller: per-pair rates water-filled from serving query mass.

Counterpart of ``repro/dist/ratectl/qos.py``.  Each ordered pair's fill
density is the EMA of its observed query mass (queries landing on the
receiving partition, weighted by the pair's halo row count), so hot
partitions' halos refresh at the lowest rates / widest widths and cold
pairs drop toward the floor.  The PI-paced allowance is water-filled over
the live pairs; ``max_width < 32`` refines each pair along the rate ×
width frontier.  The fill floor is not monotone: query traffic moves.
"""

from __future__ import annotations

import torch

from repro_torch.dist.ratectl.base import (Pacing, RateController, RatePlan,
                                           allowance, refine_widths,
                                           waterfill, width_candidates)

__all__ = ["qos_controller"]


def qos_controller(q: int, pacing: Pacing, pair_rows,
                   ema_decay: float = 0.8, name: str = "qos",
                   per_layer: bool = False,
                   max_width: int = 32) -> RateController:
    """Query-mass-weighted per-pair controller.  ``pair_rows`` is the
    static ``[Q, Q]`` halo row-count table: the water-filling's cost unit
    and the mass EMA's prior.  State: ``{"spent", "integ", "mass"}``
    (f32 CPU tensors)."""
    if per_layer:
        raise ValueError(
            "per-layer qos planning is not supported: query mass has no "
            "layer axis — use auto:qos:<bits> without :per-layer")
    rows = torch.as_tensor(pair_rows, dtype=torch.float32)
    eye = torch.eye(q, dtype=torch.bool)
    live = (rows > 0) & ~eye
    y_min = 1.0 / pacing.c_max
    candidates = width_candidates(max_width)
    # bits of one step per unit of Σ rows·y
    bits_per_rowkeep = pacing.d_full / max(float(rows.sum()), 1.0)

    def init():
        return {"spent": torch.zeros((), dtype=torch.float32),
                "integ": torch.zeros((), dtype=torch.float32),
                "mass": rows.clone()}

    def plan(state, step):
        bits, integ = allowance(pacing, state["spent"], state["integ"],
                                step)
        cap = bits / torch.tensor(bits_per_rowkeep, dtype=torch.float32)
        density = torch.where(
            live, state["mass"] / torch.clamp(rows, min=1.0),
            torch.tensor(float("-inf")))
        y = waterfill(density, rows, cap, y_min, 1.0)
        widths = None
        y_real = y
        if len(candidates) > 1:
            y_real, widths = refine_widths(y, candidates, live)
        rates = torch.where(live, 1.0 / torch.clamp(y_real, y_min, 1.0),
                            torch.tensor(1.0))
        skip = torch.zeros((q, q), dtype=torch.float32)
        return RatePlan(rates, skip, widths), {**state, "integ": integ}

    def observe(state, obs):
        if not isinstance(obs, dict):
            raise TypeError(
                "qos observe() needs the step metrics dict "
                "(keys 'transport_bits' and optionally 'query_mass'); "
                f"got {type(obs).__name__}")
        out = {**state,
               "spent": state["spent"] +
               torch.as_tensor(obs["transport_bits"], dtype=torch.float32)}
        mass = obs.get("query_mass")
        if mass is not None:
            out["mass"] = ema_decay * state["mass"] + \
                (1.0 - ema_decay) * torch.as_tensor(mass,
                                                    dtype=torch.float32)
        return out

    return RateController(name, init, observe, plan)
