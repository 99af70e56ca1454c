"""Compression-rate schedulers (paper §IV, eq. (8)).

Counterpart of ``repro/core/schedulers.py``; only the ``linear`` schedule
is ported — the rate controllers' budget pacing references it
(``repro_torch.dist.ratectl.base.make_pacing``).  Arithmetic is float32,
as in the JAX package:

    c(t) = max(c_max - a * (c_max - c_min) * t / T, c_min)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Scheduler:
    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    c_max: float
    c_min: float

    def __call__(self, step) -> torch.Tensor:
        c = self.fn(torch.as_tensor(step, dtype=torch.float32))
        return torch.clamp(c.to(torch.float32), self.c_min, self.c_max)


def linear(total_steps: int, slope: float = 5.0, c_max: float = 128.0,
           c_min: float = 1.0) -> Scheduler:
    """Paper eq. (8): linear decrease with slope multiplier ``a``."""

    def fn(t):
        c = c_max - slope * (c_max - c_min) * t / total_steps
        return torch.clamp(c, c_min, c_max)

    return Scheduler(f"linear:a={slope:g}", fn, c_max, c_min)
