"""The halo-drift gate shared by training hop reuse and serving cache
invalidation (counterpart of ``repro.dist.ratectl.stale.drift_skip``; the
``stale`` controller itself belongs to the training port)."""

from __future__ import annotations

import numpy as np


def drift_skip(delta, age, threshold: float, max_stale: int) -> np.ndarray:
    """Pair ``(i, j)`` may be served from cache (skip == 1) iff its
    measured relative drift ``delta[i, j] = ‖fresh − cached‖² / ‖fresh‖²``
    is at or below ``threshold`` AND it has been reused fewer than
    ``max_stale`` consecutive times (``age``).  The diagonal never skips.
    Compared in float32, as the JAX package does.  Returns the ``[Q, Q]``
    float32 0/1 mask."""
    delta = np.asarray(delta, np.float32)
    age = np.asarray(age, np.float32)
    eye = np.eye(delta.shape[-1], dtype=bool)
    return ((delta <= np.float32(threshold)) &
            (age < np.float32(max_stale)) & ~eye).astype(np.float32)
