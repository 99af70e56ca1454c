"""Policy layer: the communication policy (open-loop schedules and the
closed-loop controllers' specs), the bit ledger and the rate schedules."""

from .schedulers import (Scheduler, constant, cosine, exponential,
                         fixed_step, linear)
from .varco import FULL_COMM, NO_COMM, CommLedger, CommPolicy, fixed, varco

__all__ = ["CommLedger", "CommPolicy", "FULL_COMM", "NO_COMM", "Scheduler",
           "constant", "cosine", "exponential", "fixed", "fixed_step",
           "linear", "varco"]
