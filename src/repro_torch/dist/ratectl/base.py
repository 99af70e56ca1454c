"""Closed-loop rate control: the controller API + shared pacing machinery.

Counterpart of ``repro/dist/ratectl/base.py``.  A :class:`RateController`
turns a byte budget into per-step, per-pair ``[Q, Q]`` compression rates
(and wire bit-widths) from measured wire feedback, through three
functions over a state dict: ``init()``, ``plan(state, step) ->
(RatePlan, state)`` and ``observe(state, obs) -> state``.

The state is a few ``[Q, Q]`` float32 tensors kept on the host (CPU
tensors): the controller's arithmetic then matches the JAX package's f32
arithmetic, and the data plane on the card never waits on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import schedulers
from repro_torch.core.varco import WIRE_WIDTHS
from repro_torch.spans import span

#: controller names accepted by ``CommPolicy.parse("auto:<name>:<bits>")``
CONTROLLERS = ("budget", "error", "stale", "qos")

#: lane width — one fp32 scale travels per kept lane-block of a quantised
#: pair
LANE = 128

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


class RatePlan(NamedTuple):
    """One step's control decision: ``rates [Q, Q]`` (receiver × sender,
    f32, diagonal 1), ``skip [Q, Q]`` (0/1 f32: pairs served from the
    receiver's cached halo) and ``widths`` (``None`` or ``[Q, Q]`` f32 wire
    bit-widths, diagonal 32)."""

    rates: Any
    skip: Any
    widths: Any = None


@dataclasses.dataclass(frozen=True)
class RateController:
    """A closed-loop rate controller (module docs for the contract)."""

    name: str
    init_fn: Callable[[], dict]
    observe_fn: Callable[[dict, dict], dict]
    plan_fn: Callable[[dict, Any], tuple[RatePlan, dict]]

    def init(self) -> dict:
        return self.init_fn()

    def observe(self, state: dict, obs: dict) -> dict:
        with span("ratectl.observe"):
            return self.observe_fn(state, obs)

    def plan(self, state: dict, step) -> tuple[RatePlan, dict]:
        with span("ratectl.plan"):
            return self.plan_fn(state, step)


def uniform_plan(q: int, rate) -> RatePlan:
    """A scalar rate as a (diagonal-1) ``[Q, Q]`` rate map, no skips."""
    eye = torch.eye(q, dtype=torch.bool)
    rates = torch.where(eye, _f32(1.0), _f32(rate))
    return RatePlan(rates, torch.zeros((q, q), dtype=_F32))


def uniform_layer_plan(q: int, rates_l) -> RatePlan:
    """Per-layer uniform rates ``rates_l [L]`` as an ``[L, Q, Q]`` tensor
    (diagonal 1 per layer), no skips."""
    r = _f32(rates_l)
    eye = torch.eye(q, dtype=torch.bool)[None].expand(r.shape[0], q, q)
    rates = torch.where(eye, _f32(1.0), r[:, None, None].expand(-1, q, q))
    return RatePlan(rates, torch.zeros((q, q), dtype=_F32))


def waterfill(density, rows, cap, y_floor, y_max: float = 1.0,
              iters: int = 60) -> torch.Tensor:
    """Proportional (log-utility) water-filling of keep fractions: solve
    ``y = clip(λ · density, y_floor, y_max)`` for the water level ``λ``
    with ``Σ rows · y == cap`` by ``iters`` bisection halvings (f32)."""
    rows = _f32(rows)
    y_floor = torch.broadcast_to(_f32(y_floor), rows.shape)
    y_max = _f32(y_max)
    d = torch.where(rows > 0, torch.maximum(_f32(density), _f32(0.0)),
                    _f32(0.0))
    dn = d / torch.maximum(d.max(), _f32(1e-30))
    cap = torch.maximum(_f32(cap), (rows * y_floor).sum())

    def fill(lam):
        return torch.minimum(torch.maximum(lam * dn, y_floor), y_max)

    lo = torch.zeros((), dtype=_F32)
    hi = torch.full((), 1e12, dtype=_F32)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        under = (rows * fill(mid)).sum() <= cap
        lo = torch.where(under, mid, lo)
        hi = torch.where(under, hi, mid)
    return fill(lo)


# ---------------------------------------------------------------------------
# Pacing: open-loop reference trajectory + PI feedback on the spend
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pacing:
    """Budget pacing shared by every controller: the eq.-(8) linear
    schedule's keep fractions ``phi`` and their running sum ``cum`` set the
    target spend profile; ``d_full`` is the analytic full-communication
    transport of one step (forward + backward over every exchange width)."""

    total_steps: int
    budget_bits: float
    d_full: float
    c_max: float
    c_min: float
    kp: float
    ki: float
    phi: Any
    cum: Any
    layer_bits: Any = None


def make_pacing(meta, widths, total_steps: int, budget_bits: float,
                c_max: float = 128.0, c_min: float = 1.0,
                slope: float = 5.0, kp: float = 4.0,
                ki: float = 0.25, layer_widths=None) -> Pacing:
    """Build the pacing state for ``meta`` (needs ``halo_demand``) and the
    per-step exchange ``widths`` (``driver.exchange_widths``).
    ``layer_widths`` (each layer's summed exchange width,
    ``driver.layer_exchange_widths``) fills ``layer_bits`` for the
    per-layer controllers; it must sum to ``sum(widths)``."""
    if budget_bits <= 0:
        raise ValueError(f"budget_bits must be positive, got {budget_bits}")
    total = max(total_steps, 1)
    sched = schedulers.linear(total, slope=slope, c_max=c_max, c_min=c_min)
    phi = 1.0 / np.asarray([float(sched(t)) for t in range(total)])
    cum = np.concatenate([[0.0], np.cumsum(phi)])
    d_full = 2.0 * 32.0 * float(meta.halo_demand) * float(sum(widths))
    layer_bits = None
    if layer_widths is not None:
        if sum(layer_widths) != sum(widths):
            raise ValueError(
                f"layer_widths {tuple(layer_widths)} must sum to the "
                f"exchange widths' total {sum(widths)}")
        layer_bits = _f32([2.0 * 32.0 * float(meta.halo_demand) * float(w)
                           for w in layer_widths])
    return Pacing(total_steps=int(total), budget_bits=float(budget_bits),
                  d_full=d_full, c_max=float(c_max), c_min=float(c_min),
                  kp=float(kp), ki=float(ki),
                  phi=torch.from_numpy(phi.astype(np.float32)),
                  cum=torch.from_numpy(cum.astype(np.float32)),
                  layer_bits=layer_bits)


def allowance(p: Pacing, spent, integ, step):
    """This step's bit allowance: the remaining budget spent along the
    remaining open-loop profile, times a PI gain ``exp(kp·e + ki·Σe)`` on
    the pace error ``e`` (integral clamped to ±10).  Returns
    ``(bits, integ')``."""
    ti = int(min(max(int(step), 0), p.total_steps - 1))
    spent = _f32(spent)
    frac = p.cum[ti] / p.cum[-1]
    e = frac - spent / _f32(p.budget_bits)
    integ = torch.clamp(_f32(integ) + e, -10.0, 10.0)
    gain = torch.exp(_f32(p.kp) * e + _f32(p.ki) * integ)
    share = p.phi[ti] / torch.maximum(p.cum[-1] - p.cum[ti], _f32(1e-12))
    left = torch.maximum(_f32(p.budget_bits) - spent, _f32(0.0))
    return left * share * gain, integ


def rate_of_allowance(p: Pacing, bits) -> torch.Tensor:
    """Uniform rate realising a per-step bit allowance: ``d_full / bits``
    clamped to ``[max(c_min, 1), c_max]``."""
    r = _f32(p.d_full) / torch.clamp(_f32(bits), min=1.0)
    return torch.clamp(r, max(p.c_min, 1.0), p.c_max)


def sustainable_cap(p: Pacing, spent, step, bits) -> torch.Tensor:
    """Clamp one step's allowance to what the remaining budget can
    sustain for the steps left (committed monotone allocations hold for
    the rest of the run)."""
    remaining = torch.clamp(_f32(p.budget_bits) - _f32(spent), min=0.0)
    steps_left = torch.clamp(_f32(p.total_steps) - _f32(step), min=1.0)
    return torch.minimum(_f32(bits), remaining / steps_left)


# ---------------------------------------------------------------------------
# Bit-width selection: the second wire axis
# ---------------------------------------------------------------------------


def width_candidates(max_width: int) -> tuple[int, ...]:
    """Widths a controller may assign, most precise first: every supported
    storage width from 32 down to the policy floor ``max_width``."""
    return tuple(w for w in sorted(WIRE_WIDTHS, reverse=True)
                 if w >= max_width)


def width_cost(w) -> float:
    """Wire cost of width ``w`` relative to fp32 (payload plus one fp32
    scale per kept lane-block; exactly 1 at 32)."""
    return 1.0 if w >= 32 else (w + 32.0 / LANE) / 32.0


def width_eps(w) -> float:
    """Relative quantisation error proxy of width ``w``: ``1 /
    (4·qmax²)``, 0 at 32."""
    return 0.0 if w >= 32 else 1.0 / (4.0 * float(2 ** (w - 1) - 1) ** 2)


def refine_widths(y, candidates, live):
    """Per-coordinate rate × width refinement: spend each coordinate's
    fp32-cost keep fraction ``y`` at the width maximising
    ``min(y / cost_w, 1) · (1 − eps_w)`` (first maximum wins, so exact
    ties keep the more precise width).  Returns ``(y_real, widths)``."""
    y = _f32(y)
    exp = (1,) * y.dim()
    costs = _f32([width_cost(w) for w in candidates]).reshape(-1, *exp)
    eps = _f32([width_eps(w) for w in candidates]).reshape(-1, *exp)
    cands = _f32(list(candidates)).reshape(-1, *exp)
    y_w = torch.minimum(y[None] / costs, _f32(1.0))
    util = y_w * (1.0 - eps)
    idx = torch.argmax(util, dim=0, keepdim=True)
    y_real = torch.take_along_dim(y_w, idx, dim=0)[0]
    widths = torch.take_along_dim(torch.broadcast_to(cands, y_w.shape).
                                  contiguous(), idx, dim=0)[0]
    return torch.where(live, y_real, y), torch.where(live, widths, _f32(32.0))


def best_uniform_width(bits, d_full: float, candidates):
    """The uniform controllers' width pick: the single width whose cost
    retains the most of this step's allowance, ``argmax_w min(bits /
    (d_full·cost_w), 1)·(1 − eps_w)``.  Returns ``(width, cost)`` f32."""
    cands = _f32(list(candidates))
    costs = _f32([width_cost(w) for w in candidates])
    eps = _f32([width_eps(w) for w in candidates])
    y_w = torch.minimum(_f32(bits) / torch.clamp(d_full * costs, min=1e-30),
                        _f32(1.0))
    idx = torch.argmax(y_w * (1.0 - eps))
    return cands[idx], costs[idx]


def widths_map(q: int, width) -> torch.Tensor:
    """A scalar width as a (diagonal-32) ``[Q, Q]`` width map."""
    eye = torch.eye(q, dtype=torch.bool)
    return torch.where(eye, _f32(32.0), _f32(width))


# ---------------------------------------------------------------------------
# Per-layer fill (the per-layer budget controller)
# ---------------------------------------------------------------------------


def init_layer_fill(p: Pacing) -> dict:
    """Per-layer fill state: the dropped-energy EMA (initialised to
    ``layer_bits``: uniform density) and the monotone keep-fraction
    floors."""
    return {"ema": _f32(p.layer_bits).clone(),
            "y": torch.full(p.layer_bits.shape, 1.0 / p.c_max, dtype=_F32)}


def plan_layer_fill(p: Pacing, state: dict, step, cost_factor=1.0):
    """One per-layer planning step: PI allowance → sustainable cap →
    water-fill over ``layer_bits`` weighted by the dropped-energy EMA,
    floored at the prior commitments.  ``cost_factor`` (the chosen
    width's :func:`width_cost`) deflates the cap into fp32-equivalent
    keep units.  Returns ``(rates_l [L], integ', y')``."""
    bits, integ = allowance(p, state["spent"], state["integ"], step)
    cap = sustainable_cap(p, state["spent"], step, bits) / cost_factor
    density = state["ema"] / torch.clamp(p.layer_bits, min=1e-30)
    y = waterfill(density, p.layer_bits, cap, state["y"], 1.0)
    rates_l = torch.clamp(1.0 / torch.clamp(y, 1.0 / p.c_max, 1.0),
                          max(p.c_min, 1.0), p.c_max)
    return rates_l, integ, y


def fold_layer_err(state: dict, obs: dict, ema_decay: float) -> dict:
    """The per-layer observe update: fold ``obs["layer_err"]`` (summed
    over pairs) into the dropped-energy EMA.  The key is required."""
    err_l = _f32(obs["layer_err"]).sum(dim=(1, 2))
    return {"ema": ema_decay * state["ema"] + (1.0 - ema_decay) * err_l}
