"""VARCO communication policy and the two-column bit ledger.

Counterpart of ``repro/core/varco.py``.  :class:`CommPolicy` is the
static description of a run's communication scheme:

* ``full`` (the paper's Full Comm baseline), ``none`` (No Comm: workers
  never exchange halo activations), ``fixed:<r>`` (Fixed Compression) and
  ``varco:<sched>`` (the paper's method) — open-loop, one scalar rate per
  step from a :mod:`~repro_torch.core.schedulers` schedule;
* ``auto:<controller>:<budget-bits>[:w<width>][:per-layer]`` — closed
  loop: a ``repro_torch.dist.ratectl`` controller plans per-pair rates
  (and wire widths) from measured transport.

:meth:`CommPolicy.compressor` is the named
:mod:`~repro_torch.core.compression` compressor: the dense wire applies
any of them to each worker's boundary block, while the packed and p2p
wires realise ``blockmask`` with the pack/unpack kernels (closed-loop
policies ride those wires, so they must name ``blockmask``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import schedulers
from .compression import Compressor, get_compressor
from .schedulers import Scheduler

MODES = ("full", "none", "fixed", "varco", "auto")

#: closed-loop controllers reachable via ``auto:<controller>:<bits>``
AUTO_CONTROLLERS = ("budget", "error", "stale", "qos")

#: supported wire storage bit-widths (2/4/8 quantised, 32 exact fp32)
WIRE_WIDTHS = (2, 4, 8, 32)


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """Static description of the communication scheme for a run.

    ``auto`` mode names a closed-loop controller, its total wire budget in
    bits, the lowest bit-width it may quantise a pair's payload to
    (``max_width``; 32 keeps the wire exact fp32) and whether it plans
    per-layer ``[L, Q, Q]`` tensors; ``rate(step)`` is undefined for it.
    """

    mode: str = "full"
    scheduler: Scheduler | None = None
    compressor_name: str = "randmask"
    controller: str | None = None
    budget_bits: float = 0.0
    per_layer: bool = False
    max_width: int = 32

    def __post_init__(self):
        if self.per_layer and self.mode != "auto":
            raise ValueError(
                f"per_layer rate planning is a closed-loop (auto) feature; "
                f"mode {self.mode!r} plans one scalar rate per step")
        if self.max_width not in WIRE_WIDTHS:
            raise ValueError(
                f"max_width must be one of {WIRE_WIDTHS} (supported wire "
                f"storage widths), got {self.max_width!r}")
        if self.max_width < 32 and self.mode != "auto":
            raise ValueError(
                f"quantised wire widths are planned closed-loop per pair; "
                f"max_width < 32 needs mode 'auto', got mode {self.mode!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got "
                             f"{self.mode!r}")
        if self.mode in ("fixed", "varco") and self.scheduler is None:
            raise ValueError(f"mode {self.mode!r} requires a scheduler")
        if self.mode == "auto":
            if self.controller not in AUTO_CONTROLLERS:
                raise ValueError(
                    f"auto mode needs a controller in {AUTO_CONTROLLERS}, "
                    f"got {self.controller!r}")
            if not self.budget_bits > 0:
                raise ValueError(f"auto mode needs a positive bit budget, "
                                 f"got {self.budget_bits!r}")
            if self.compressor_name != "blockmask":
                raise ValueError(
                    "auto mode rides the p2p wire, which ships "
                    "PRNG-selected lane-blocks; the compressor must be "
                    f"'blockmask', got {self.compressor_name!r}")

    @staticmethod
    def parse(spec: str, total_steps: int, compressor: str | None = None
              ) -> "CommPolicy":
        """Parse ``full`` | ``none`` | ``fixed:<r>`` | ``varco:linear:<a>``
        | ``varco:exp`` | ``varco:cosine`` | ``varco:step:<R>`` |
        ``auto:<controller>:<budget-bits>[:w<width>][:per-layer]`` (the
        two auto suffixes compose in either order).  ``str(policy)``
        returns the canonical spec and round-trips through ``parse``."""
        spec = spec.strip().lower()
        if spec == "full":
            return CommPolicy("full")
        if spec == "none":
            return CommPolicy("none")
        kind, _, rest = spec.partition(":")
        if kind == "fixed":
            return CommPolicy("fixed", schedulers.constant(float(rest)),
                              compressor or "randmask")
        if kind == "varco":
            return CommPolicy("varco",
                              schedulers.parse(rest or "linear:5",
                                               total_steps),
                              compressor or "randmask")
        if kind == "auto":
            parts = rest.split(":")
            if len(parts) < 2 or not parts[0] or not parts[1]:
                raise ValueError(
                    f"auto spec is auto:<controller>:<budget-bits>"
                    f"[:w<width>][:per-layer], got {spec!r}")
            per_layer, max_width = False, 32
            for suffix in parts[2:]:
                if suffix == "per-layer":
                    per_layer = True
                elif len(suffix) > 1 and suffix[0] == "w" \
                        and suffix[1:].isdigit():
                    w = int(suffix[1:])
                    if w not in WIRE_WIDTHS:
                        raise ValueError(
                            f"wire width must be one of {WIRE_WIDTHS}, "
                            f"got w{w} in {spec!r}")
                    max_width = w
                else:
                    raise ValueError(
                        f"unknown auto suffix {suffix!r} in {spec!r} "
                        f"('w<width>' and 'per-layer' are defined)")
            return CommPolicy("auto", compressor_name=compressor or
                              "blockmask", controller=parts[0],
                              budget_bits=float(parts[1]),
                              per_layer=per_layer, max_width=max_width)
        raise ValueError(f"unknown comm spec {spec!r}")

    def __str__(self) -> str:
        """Canonical parseable spec (``w`` suffix before ``per-layer``)."""
        if self.mode in ("full", "none"):
            return self.mode
        if self.mode == "auto":
            s = f"auto:{self.controller}:{self.budget_bits:g}"
            if self.max_width < 32:
                s += f":w{self.max_width}"
            if self.per_layer:
                s += ":per-layer"
            return s
        if self.mode == "fixed":
            return self.scheduler.name              # "fixed:<r>"
        name = self.scheduler.name                  # varco schedules
        for prefix, canon in (("linear:a=", "linear:"), ("step:R=", "step:")):
            if name.startswith(prefix):
                return f"varco:{canon}{name[len(prefix):]}"
        return f"varco:{name}"

    @property
    def communicates(self) -> bool:
        return self.mode != "none"

    @property
    def compresses(self) -> bool:
        return self.mode in ("fixed", "varco", "auto")

    def compressor(self) -> Compressor:
        return get_compressor(self.compressor_name)

    def rate(self, step) -> torch.Tensor:
        """Compression ratio at ``step`` (1.0 for full communication), a
        float32 CPU scalar."""
        if self.mode == "auto":
            raise ValueError(
                "auto policies plan rates closed-loop per step — drive the "
                "run via repro_torch.dist.ratectl (train_gnn does this) "
                "instead of querying a schedule")
        if not self.compresses:
            return torch.ones((), dtype=torch.float32)
        return self.scheduler(step)

    def describe(self) -> str:
        if self.mode in ("full", "none"):
            return self.mode
        if self.mode == "auto":
            pl = ",per-layer" if self.per_layer else ""
            w = f",w{self.max_width}" if self.max_width < 32 else ""
            return (f"auto({self.controller},{self.budget_bits:g}b,"
                    f"{self.compressor_name}{w}{pl})")
        return f"{self.mode}({self.scheduler.name},{self.compressor_name})"


FULL_COMM = CommPolicy("full")
NO_COMM = CommPolicy("none")


def fixed(rate: float, compressor: str = "randmask") -> CommPolicy:
    return CommPolicy("fixed", schedulers.constant(rate), compressor)


def varco(total_steps: int, slope: float = 5.0, c_max: float = 128.0,
          c_min: float = 1.0, compressor: str = "randmask") -> CommPolicy:
    return CommPolicy(
        "varco",
        schedulers.linear(total_steps, slope=slope, c_max=c_max, c_min=c_min),
        compressor)


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
