"""Controller factory and the serving forward's halo-cache shapes.

Counterpart of the serving-side part of ``repro/dist/ratectl/driver.py``:
:func:`exchange_widths`, :func:`init_halo_cache` and
:func:`make_controller` (``qos`` only so far).
"""

from __future__ import annotations

import torch

from repro_torch.core.varco import CommPolicy
from repro_torch.dist.ratectl.base import RateController, make_pacing
from repro_torch.dist.ratectl.qos import qos_controller


def exchange_widths(cfg) -> tuple[int, ...]:
    """Feature width of every halo exchange in one forward pass: each
    layer's input width, once per exchange call (sage: one per layer;
    poly: ``k_taps - 1`` per layer)."""
    dims = [cfg.in_dim] + [cfg.hidden] * (cfg.layers - 1)
    reps = 1 if cfg.conv == "sage" else max(cfg.k_taps - 1, 1)
    return tuple(d for d in dims for _ in range(reps))


def make_controller(policy: CommPolicy, meta, cfg, total_steps: int,
                    **overrides) -> RateController:
    """Instantiate ``policy.controller`` with pacing scaled to
    ``policy.budget_bits`` over ``total_steps``.  ``overrides`` pass to
    :func:`make_pacing` (``c_max``, ``slope``, ``kp``, ``ki``, ...) and
    ``ema_decay`` to the controller."""
    if policy.controller != "qos":
        raise NotImplementedError(
            f"the {policy.controller!r} controller is not ported yet "
            f"(ROADMAP queue 1: rate control); the port runs 'qos'")
    ctl_kw = {k: overrides.pop(k) for k in ("ema_decay",) if k in overrides}
    pacing = make_pacing(meta, exchange_widths(cfg), total_steps,
                         policy.budget_bits, **overrides)
    return qos_controller(meta.q, pacing, meta.pair_table(),
                          per_layer=policy.per_layer,
                          max_width=policy.max_width, **ctl_kw)


def init_halo_cache(meta, cfg, device="cuda") -> tuple:
    """Zero-initialised per-exchange hop-buffer caches (``[Q, D, H,
    width]`` per exchange call; p2p wire).  Never read before the first
    refresh fills them — step 0 never skips."""
    d = max(meta.q - 1, 1)
    return tuple(torch.zeros((meta.q, d, meta.p2p_hop_width, w),
                             dtype=torch.float32, device=device)
                 for w in exchange_widths(cfg))
