"""Policy layer: the communication policy (open-loop schedules and the
closed-loop controllers' specs), the bit ledger, the rate schedules and
the Definition-1 compressors."""

from .compression import (Compressed, Compressor, available_compressors,
                          get_compressor, straight_through)
from .schedulers import (Scheduler, constant, cosine, exponential,
                         fixed_step, linear)
from .varco import FULL_COMM, NO_COMM, CommLedger, CommPolicy, fixed, varco

__all__ = ["CommLedger", "CommPolicy", "Compressed", "Compressor",
           "FULL_COMM", "NO_COMM", "Scheduler", "available_compressors",
           "constant", "cosine", "exponential", "fixed", "fixed_step",
           "get_compressor", "linear", "straight_through", "varco"]
