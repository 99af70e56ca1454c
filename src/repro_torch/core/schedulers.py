"""Compression-rate schedulers (paper §IV + Appendix A, eq. (8)).

Counterpart of ``repro/core/schedulers.py``: a scheduler maps a train
step ``t`` to a compression ratio ``c(t) >= 1``, monotone non-increasing
as Proposition 2 asks.  Arithmetic is float32 on the host, as in the JAX
package:

    c(t) = max(c_max - a * (c_max - c_min) * t / T, c_min)
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Scheduler:
    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    c_max: float
    c_min: float

    def __call__(self, step) -> torch.Tensor:
        # clamp both ends: a mis-specified fn can neither dip below c_min
        # nor exceed c_max
        c = self.fn(_f32(step)).to(torch.float32)
        return torch.clamp(c, self.c_min, self.c_max)


# the schedule functions are module-level and bound with ``partial``, so
# a scheduler (and the policy holding it) pickles into spawned workers


def _constant_fn(t, c):
    return _f32(c)


def _linear_fn(t, total_steps, slope, c_max, c_min):
    c = c_max - slope * (c_max - c_min) * t / total_steps
    return torch.clamp(c, c_min, c_max)


def _fixed_step_fn(t, decrement, c_max, c_min):
    return torch.clamp(c_max - decrement * t, c_min, c_max)


def _exponential_fn(t, total_steps, c_max, ratio):
    frac = torch.clamp(t / total_steps, 0.0, 1.0)
    return c_max * torch.pow(ratio, frac)


def _cosine_fn(t, total_steps, c_max, c_min):
    frac = torch.clamp(t / total_steps, 0.0, 1.0)
    return c_min + 0.5 * (c_max - c_min) * (1.0 + torch.cos(math.pi * frac))


def constant(c: float) -> Scheduler:
    """Fixed compression ratio (the paper's 'Fixed Comp Rate' baselines)."""
    return Scheduler(f"fixed:{c:g}", partial(_constant_fn, c=c), c, c)


def linear(total_steps: int, slope: float = 5.0, c_max: float = 128.0,
           c_min: float = 1.0) -> Scheduler:
    """Paper eq. (8): linear decrease with slope multiplier ``a``."""
    return Scheduler(f"linear:a={slope:g}",
                     partial(_linear_fn, total_steps=total_steps,
                             slope=slope, c_max=c_max, c_min=c_min),
                     c_max, c_min)


def fixed_step(total_steps: int, decrement: float, c_max: float = 128.0,
               c_min: float = 1.0) -> Scheduler:
    """Appendix A 'fixed rate' variant: ``c_{k+1} = c_k - R``."""
    del total_steps
    return Scheduler(f"step:R={decrement:g}",
                     partial(_fixed_step_fn, decrement=decrement,
                             c_max=c_max, c_min=c_min), c_max, c_min)


def exponential(total_steps: int, c_max: float = 128.0, c_min: float = 1.0
                ) -> Scheduler:
    """Appendix A exponential variant: geometric decay c_max -> c_min."""
    return Scheduler("exp", partial(_exponential_fn,
                                    total_steps=total_steps, c_max=c_max,
                                    ratio=_f32(c_min / c_max)),
                     c_max, c_min)


def cosine(total_steps: int, c_max: float = 128.0, c_min: float = 1.0
           ) -> Scheduler:
    """Cosine anneal (smooth endpoints, still monotone)."""
    return Scheduler("cosine", partial(_cosine_fn, total_steps=total_steps,
                                       c_max=c_max, c_min=c_min),
                     c_max, c_min)


def parse(spec: str, total_steps: int) -> Scheduler:
    """Parse 'full' | 'fixed:4' | 'linear:5' | 'exp' | 'cosine' |
    'step:0.5'."""
    spec = spec.strip().lower()
    if spec in ("full", "off", "1"):
        return constant(1.0)
    if spec == "exp":
        return exponential(total_steps)
    if spec == "cosine":
        return cosine(total_steps)
    kind, _, arg = spec.partition(":")
    if kind == "fixed":
        return constant(float(arg))
    if kind == "linear":
        return linear(total_steps, slope=float(arg) if arg else 5.0)
    if kind == "step":
        return fixed_step(total_steps, decrement=float(arg))
    raise ValueError(f"unknown scheduler spec {spec!r}")
