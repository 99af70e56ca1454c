"""Policy layer: the closed-loop communication policy, the bit ledger and
the eq.-(8) linear schedule the budget pacing references."""

from .schedulers import Scheduler, linear
from .varco import CommLedger, CommPolicy

__all__ = ["CommLedger", "CommPolicy", "Scheduler", "linear"]
