"""``error`` controller: per-pair rates water-filled from measured error.

Counterpart of ``repro/dist/ratectl/error.py``.  Every step the
controller takes the budget pacing's bit allowance and water-fills it
over the pairs by descending measured compression-error density — the
EMA of each pair's dropped-block energy per boundary row — so pairs that
lose the most energy to compression communicate at the lowest rates.
The keep fractions ``y = 1/rate`` are monotone non-increasing in rate
(``y`` only grows, each step capped by what the remaining budget can
sustain), so Proposition 2's convergence argument applies unchanged.

``per_layer=True`` lifts the fill to the joint ``[L, Q, Q]`` index set
(cost ``rows[i, j] · layer_width[l]`` wire bits); ``max_width < 32``
refines each coordinate along the rate × width frontier
(:func:`~repro_torch.dist.ratectl.base.refine_widths`), with ``y`` kept
in fp32-cost units.  State is float32 CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.dist.ratectl.base import (Pacing, RateController, RatePlan,
                                           allowance, refine_widths,
                                           sustainable_cap, waterfill,
                                           width_candidates)

__all__ = ["error_controller"]

_F32 = torch.float32


def error_controller(q: int, pacing: Pacing, pair_rows,
                     ema_decay: float = 0.8, name: str = "error",
                     per_layer: bool = False,
                     max_width: int = 32) -> RateController:
    """Error-weighted per-pair controller.  ``pair_rows`` is the static
    ``[Q, Q]`` halo row-count table: the water-filling's cost unit and
    the error EMA's initial value.  State: ``{"spent", "integ", "ema",
    "y"}`` with ``y`` the monotone keep fractions (``[Q, Q]``, or ``[L,
    Q, Q]`` per layer, which needs ``pacing.layer_bits``).  ``observe``
    needs ``pair_err`` (``layer_err`` per layer)."""
    rows = torch.as_tensor(pair_rows, dtype=_F32)
    eye = torch.eye(q, dtype=torch.bool)
    live = (rows > 0) & ~eye
    y_min = 1.0 / pacing.c_max
    candidates = width_candidates(max_width)
    if per_layer:
        if pacing.layer_bits is None:
            raise ValueError(
                "per_layer needs pacing.layer_bits — build the pacing "
                "with make_pacing(..., layer_widths=...)")
        # cost[l, i, j] in bits per unit keep fraction: layer l's bits
        # split over its pairs by halo rows
        total_rows = torch.clamp(rows.sum(), min=1.0)
        rows_fill = pacing.layer_bits[:, None, None] * rows[None] / total_rows
        live = live[None].expand(rows_fill.shape)
        floor = torch.tensor(1e-30, dtype=_F32)
    else:
        # bits of one train step per unit of Σ rows·y
        bits_per_rowkeep = torch.tensor(
            pacing.d_full / max(float(rows.sum()), 1.0), dtype=_F32)
        rows_fill = rows
        floor = torch.tensor(1.0, dtype=_F32)

    def init():
        return {"spent": torch.zeros((), dtype=_F32),
                "integ": torch.zeros((), dtype=_F32),
                "ema": rows_fill.clone(),
                "y": torch.full(rows_fill.shape, y_min, dtype=_F32)}

    def plan(state, step):
        bits, integ = allowance(pacing, state["spent"], state["integ"], step)
        # the monotone y commits every allocation for the rest of the run:
        # cap the step by what the remaining budget can sustain
        cap_bits = sustainable_cap(pacing, state["spent"], step, bits)
        cap = cap_bits if per_layer else cap_bits / bits_per_rowkeep
        density = torch.where(
            live, state["ema"] / torch.maximum(rows_fill, floor),
            torch.tensor(float("-inf")))
        # prior commitments are the fill's floor: monotone by construction
        y = waterfill(density, rows_fill, cap, state["y"], 1.0)
        widths = None
        y_real = y
        if len(candidates) > 1:
            y_real, widths = refine_widths(y, candidates, live)
        rates = torch.where(live, 1.0 / torch.clamp(y_real, y_min, 1.0),
                            torch.tensor(1.0))
        return RatePlan(rates, torch.zeros((q, q), dtype=_F32), widths), \
            {**state, "integ": integ, "y": y}

    def observe(state, obs):
        # the measurement is the controller's reason to exist: a missing
        # key fails loudly instead of freezing the EMA
        err = torch.as_tensor(obs["layer_err" if per_layer else "pair_err"],
                              dtype=_F32)
        return {**state,
                "spent": state["spent"] +
                torch.as_tensor(obs["transport_bits"], dtype=_F32),
                "ema": ema_decay * state["ema"] + (1.0 - ema_decay) * err}

    return RateController(name, init, observe, plan)
