"""VARCO communication policy and the two-column bit ledger.

Counterpart of ``repro/core/varco.py`` for the serving slice: the
closed-loop ``auto:<controller>:<budget-bits>[:w<width>][:per-layer]``
policies the rate controllers run, and :class:`CommLedger`.  The
open-loop modes (``full``, ``none``, ``fixed:<r>``, ``varco:<sched>``)
belong to the training port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses

import torch

MODES = ("auto",)

#: closed-loop controllers reachable via ``auto:<controller>:<bits>``
#: (only ``qos`` has a ported implementation so far)
AUTO_CONTROLLERS = ("budget", "error", "stale", "qos")

#: supported wire storage bit-widths (2/4/8 quantised, 32 exact fp32)
WIRE_WIDTHS = (2, 4, 8, 32)


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """Static description of a closed-loop communication scheme: the
    controller, its total wire budget in bits, and the lowest bit-width
    it may quantise a pair's payload to (``max_width``; 32 keeps the wire
    exact fp32)."""

    mode: str = "auto"
    controller: str | None = None
    budget_bits: float = 0.0
    per_layer: bool = False
    max_width: int = 32

    def __post_init__(self):
        if self.mode not in MODES:
            raise NotImplementedError(
                f"mode {self.mode!r} is not ported yet (ROADMAP queue 1: "
                f"training slice); the port runs 'auto' policies")
        if self.max_width not in WIRE_WIDTHS:
            raise ValueError(
                f"max_width must be one of {WIRE_WIDTHS} (supported wire "
                f"storage widths), got {self.max_width!r}")
        if self.controller not in AUTO_CONTROLLERS:
            raise ValueError(
                f"auto mode needs a controller in {AUTO_CONTROLLERS}, "
                f"got {self.controller!r}")
        if not self.budget_bits > 0:
            raise ValueError(f"auto mode needs a positive bit budget, "
                             f"got {self.budget_bits!r}")

    @staticmethod
    def parse(spec: str, total_steps: int = 1) -> "CommPolicy":
        """Parse ``auto:<controller>:<budget-bits>[:w<width>][:per-layer]``
        (the suffixes compose in either order).  ``total_steps`` is kept
        for signature parity with the JAX package."""
        del total_steps
        spec = spec.strip().lower()
        kind, _, rest = spec.partition(":")
        if kind != "auto":
            raise NotImplementedError(
                f"comm spec {spec!r} is not ported yet (ROADMAP queue 1: "
                f"training slice); the port parses auto:<controller>:<bits>")
        parts = rest.split(":")
        if len(parts) < 2 or not parts[0] or not parts[1]:
            raise ValueError(f"auto spec is auto:<controller>:<budget-bits>"
                             f"[:w<width>][:per-layer], got {spec!r}")
        per_layer, max_width = False, 32
        for suffix in parts[2:]:
            if suffix == "per-layer":
                per_layer = True
            elif len(suffix) > 1 and suffix[0] == "w" and suffix[1:].isdigit():
                w = int(suffix[1:])
                if w not in WIRE_WIDTHS:
                    raise ValueError(f"wire width must be one of "
                                     f"{WIRE_WIDTHS}, got w{w} in {spec!r}")
                max_width = w
            else:
                raise ValueError(f"unknown auto suffix {suffix!r} in {spec!r}"
                                 f" ('w<width>' and 'per-layer' are defined)")
        return CommPolicy("auto", controller=parts[0],
                          budget_bits=float(parts[1]), per_layer=per_layer,
                          max_width=max_width)

    def __str__(self) -> str:
        s = f"auto:{self.controller}:{self.budget_bits:g}"
        if self.max_width < 32:
            s += f":w{self.max_width}"
        if self.per_layer:
            s += ":per-layer"
        return s


@dataclasses.dataclass
class CommLedger:
    """Cumulative wire-traffic counter, float32 on the host like the JAX
    package's: ``bits`` is the analytic point-to-point charge, ``transport``
    the bits the wire format actually shipped."""

    bits: torch.Tensor
    transport: torch.Tensor

    @staticmethod
    def zero() -> "CommLedger":
        return CommLedger(torch.zeros((), dtype=torch.float32),
                          torch.zeros((), dtype=torch.float32))

    def add_bits(self, bits, transport=None) -> "CommLedger":
        """Charge one exchange (``transport`` defaults to ``bits``)."""
        b = torch.as_tensor(bits, dtype=torch.float32)
        t = b if transport is None else \
            torch.as_tensor(transport, dtype=torch.float32)
        return CommLedger(self.bits + b, self.transport + t)

    @property
    def floats(self) -> torch.Tensor:
        """Equivalent f32 floats communicated (paper Fig. 5 unit)."""
        return self.bits / 32.0
