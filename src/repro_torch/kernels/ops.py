"""Public wire and aggregation ops, dispatched by the tensor's device.

Counterpart of ``repro/kernels/ops.py`` for the serving forward.  Each op
that has a kernel runs it on a CUDA tensor and its plain PyTorch version
on a CPU tensor; any other device raises.  There is no fallback from the
kernel to the plain version and no global backend switch — the tensor
decides.

* :func:`wire_pack` / :func:`wire_unpack` — lane-block gather/scatter
  (``varco_pack`` / ``varco_unpack`` kernels);
* :func:`ell_aggregate` — the local-edge ELL aggregation (``ell_spmm``
  kernel), forward only;
* the quantised-wire codecs (:func:`quant_levels`, :func:`pack_bits`,
  :func:`dequant_bits`, :func:`quant_dequant`, :func:`wire_quant`) —
  elementwise PyTorch on every device, as the JAX runtime composes jnp
  ``quant_levels`` + ``pack_bits`` on its sub-byte hop path.

Every op takes a leading batch dimension (``[Q, N, F]`` with per-batch
index rows) or, for the wire ops, an unbatched ``[N, F]`` with one index
vector.
"""

from __future__ import annotations

import torch

from . import ref
from .ell_spmm import ell_spmm, ell_spmm_plain
from .varco_pack import (LANE, varco_pack, varco_pack_plain, varco_unpack,
                         varco_unpack_plain)

#: wire bit-widths the quantised codecs speak — 32 is the fp32 passthrough,
#: the rest symmetric per-lane-block int formats bit-packed to sub-byte
#: storage (8/w lanes per byte)
WIRE_WIDTHS = (2, 4, 8, 32)


def _route(kernel, plain, *tensors):
    dev = tensors[0].device
    if dev.type == "cuda":
        return kernel(*tensors)
    if dev.type == "cpu":
        return plain(*tensors)
    raise ValueError(f"no kernel or plain version for device {dev}")


def _batched(fn, x, idx):
    if x.dim() == 2:
        return fn(x[None], idx[None])[0]
    return fn(x, idx)


def wire_pack(x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """Gather kept lane-blocks: ``[Q, N, F] -> [Q, N, K·128]`` with
    ``kept [Q, K]`` (or ``[N, F]`` with ``kept [K]``)."""
    return _batched(lambda a, b: _route(varco_pack, varco_pack_plain, a, b),
                    x, kept)


def wire_unpack(packed: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Scatter a wire payload back: ``[Q, M, K·128] -> [Q, M, F]`` with
    ``inv [Q, F/128]``, zero-filling dropped blocks (``inv < 0``)."""
    return _batched(
        lambda a, b: _route(varco_unpack, varco_unpack_plain, a, b),
        packed, inv)


def ell_aggregate(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor
                  ) -> torch.Tensor:
    """ELL aggregation ``out[q, i] = Σ_k w[q, i, k] x[q, nbr[q, i, k]]``
    over every partition at once (forward only; the reversed-list
    backward is a later port)."""
    return _route(ell_spmm, ell_spmm_plain, x, nbr, w)


# ---------------------------------------------------------------------------
# Quantised wire codecs
# ---------------------------------------------------------------------------


def _width_tensor(width, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(width, dtype=torch.float32, device=like.device)


def quant_levels(x: torch.Tensor, width) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lane-block symmetric round-to-nearest-even quantisation:
    ``x [..., nb·128]`` -> ``(int8 levels [..., nb·128], f32 scales
    [..., nb])`` with ``qmax = 2^(w-1) - 1`` and ``scale = amax/qmax``
    (1 for an all-zero block).  ``width`` is a number or a tensor
    broadcastable against the scales; ``width >= 32`` yields levels that
    callers on the fp32 passthrough discard."""
    lead = x.shape[:-1]
    nb = x.shape[-1] // LANE
    xb = x.reshape(*lead, nb, LANE)
    w = _width_tensor(width, x)
    qmax = 2.0 ** (w - 1.0) - 1.0
    amax = xb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    qv = torch.round(xb / scale[..., None])
    qm = torch.broadcast_to(qmax, scale.shape)[..., None]
    qv = torch.minimum(torch.maximum(qv, -qm), qm)
    return qv.to(torch.int8).reshape(x.shape), scale


def quant_dequant(x: torch.Tensor, width) -> torch.Tensor:
    """Symmetric per-lane-block quantise→dequantise at ``width`` bits;
    ``width >= 32`` is an exact fp32 passthrough."""
    lead = x.shape[:-1]
    nb = x.shape[-1] // LANE
    xb = x.reshape(*lead, nb, LANE)
    w = _width_tensor(width, x)
    levels, scale = quant_levels(x, width)
    dq = levels.to(torch.float32).reshape(*lead, nb, LANE) * scale[..., None]
    exact = torch.broadcast_to(w >= 32.0, scale.shape)[..., None]
    return torch.where(exact, xb, dq).reshape(x.shape)


def wire_quant(x: torch.Tensor, width) -> torch.Tensor:
    """The quantised wire's delivered values, ``x + (quant_dequant(x) -
    x)`` — the JAX package's straight-through form, kept term for term so
    the rounding matches (serving runs no backward)."""
    return x + (quant_dequant(x, width) - x)


def pack_bits(levels: torch.Tensor, width: int) -> torch.Tensor:
    """Bit-pack int-``width`` levels to bytes (``8/width`` lanes per byte,
    little-endian; ``width == 8`` is the identity reinterpret)."""
    return ref.pack_bits_reference(levels, width)


def dequant_bits(payload: torch.Tensor, scales: torch.Tensor, width: int
                 ) -> torch.Tensor:
    """Value-level decode of a sub-byte wire buffer: payload uint8
    ``[..., K·128·width/8]`` × scales f32 ``[..., K]`` -> f32
    ``[..., K·128]`` (``levels · scale``)."""
    k = scales.shape[-1]
    levels = ref.unpack_bits_reference(payload, width, k * LANE)
    lb = levels.to(torch.float32).reshape(*scales.shape, LANE)
    return (lb * scales[..., None]).reshape(*payload.shape[:-1], k * LANE)


def per_block_wire_bits(width) -> torch.Tensor:
    """On-wire bits of ONE kept lane-block per row at ``width``: the
    ``128·width`` payload plus one fp32 scale, or exactly ``128·32`` on
    the fp32 wire (no scale ships)."""
    w = torch.as_tensor(width, dtype=torch.float32)
    return torch.where(w >= 32.0, torch.tensor(LANE * 32.0),
                       LANE * w + 32.0)
