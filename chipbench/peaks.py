"""Published peaks of the cards the benchmark runs on, and the least time
a kernel could take against them.

NVIDIA H100 SXM (data sheet, dense rates): 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM3.  The 32-bit integer rate is 128
results per SM per clock (four schedulers, one 32-lane warp instruction
each) × 132 SMs × the 1.98 GHz maximum SM clock.  These rates assume the
card's full 700 W power limit; each run prints the limit it had.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12,
                              "int32_ops": 128 * 132 * 1.98e9},
}


def peaks_for(device_name: str) -> dict | None:
    """The peaks of the named card (``torch.cuda.get_device_name``), or
    ``None`` for a card not in the table."""
    return PEAKS.get(device_name)


def bound_s(peak: dict, n_bytes: float, ops: float = 0.0,
            ops_kind: str = "f32_flops") -> float:
    """The least seconds the card could take: the larger of ``n_bytes``
    over the memory rate and ``ops`` over the peak of their kind."""
    return max(n_bytes / peak["hbm_bytes"], ops / peak[ops_kind])
