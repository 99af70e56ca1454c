"""Collective accounting of a traced step — counterpart of
``repro/launch/hlo_analysis.py``'s ``collective_bytes``.

The JAX package parses the collectives out of XLA's optimised HLO text;
the port has no HLO.  Here a ``TorchDispatchMode``
(:class:`CollectiveCounter`) sees every ``_c10d_functional`` collective
that DTensor issues while a step runs under it (on a fake process group
and fake tensors in the dry run, or on a real group), and charges it
per device with the ring model of ``hlo_analysis``
(``src/repro/launch/hlo_analysis.py:121-130``), ``r`` the result
tensor's bytes and ``g`` the group size:

* all-reduce         ``2 (g-1)/g · r``
* all-gather         ``(g-1)/g · r``   (``r`` the gathered result)
* reduce-scatter     ``(g-1) · r``     (``r`` the scattered result)
* all-to-all         ``(g-1)/g · r``
* collective-permute ``r``

The result is ``hlo_analysis``' dict: ``per_kind``, ``per_dtype`` (HLO
dtype names), ``bytes`` and ``ops``.  Two of its parts have no
counterpart.  A Python loop over the blocks issues each block's
collectives once per block, so every collective is seen as often as it
runs and no ``while`` trip-count multiplier is needed.  And there is no
``bf16_normalized_bytes``: it corrects XLA:CPU's upcast of bf16
collectives to f32, which the port does not have.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: HLO's names of the dtypes (the keys of ``per_dtype``)
_HLO_DTYPE = {torch.float64: "f64", torch.float32: "f32",
              torch.bfloat16: "bf16", torch.float16: "f16",
              torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
              torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def ring_bytes(kind: str, r: float, g: int) -> float:
    """Per-device wire bytes of one collective of result bytes ``r`` over
    a group of ``g`` under the ring model (module docstring)."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * r
    if kind == "all-gather":
        return (g - 1) / g * r
    if kind == "reduce-scatter":
        return (g - 1.0) * r
    if kind == "all-to-all":
        return (g - 1) / g * r
    if kind == "collective-permute":
        return float(r)
    raise ValueError(f"unknown collective kind {kind!r}")


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


def _collective(func, args) -> tuple | None:
    """``(kind, group size)`` of a functional collective, else None."""
    ns = func.namespace
    name = func._overloadpacket.__name__
    if ns == "_c10d_functional":
        if name == "all_reduce":                 # (x, op, group)
            return "all-reduce", _group_size(args[2])
        if name == "all_gather_into_tensor":     # (x, g, group)
            return "all-gather", int(args[1])
        if name == "reduce_scatter_tensor":      # (x, op, g, group)
            return "reduce-scatter", int(args[2])
        if name == "all_to_all_single":          # (x, out, in, group)
            return "all-to-all", _group_size(args[3])
    return None


class CollectiveCounter(TorchDispatchMode):
    """Counts the wire bytes of every functional collective issued while
    it is active (module docstring).  :meth:`summary` gives the
    ``hlo_analysis.collective_bytes`` dict.

    Example::

        with CollectiveCounter() as comm:
            step(params, opt_state, batch)
        comm.summary()["bytes"]       # per device, per step
    """

    def __init__(self):
        super().__init__()
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            # let DTensor desugar the op into local ops and collectives
            # first, which then come back through this mode (as
            # torch.distributed.tensor.debug.CommDebugMode does)
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        hit = _collective(func, args)
        if hit is not None:
            kind, g = hit
            r = out.numel() * out.element_size()
            self.records.append((kind, _HLO_DTYPE.get(out.dtype, "f32"),
                                 ring_bytes(kind, r, g)))
        return out

    def summary(self) -> dict:
        per_kind: dict = {}
        per_dtype: dict = {}
        for kind, dt, b in self.records:
            per_kind[kind] = per_kind.get(kind, 0.0) + b
            per_dtype[dt] = per_dtype.get(dt, 0.0) + b
        return {"per_kind": per_kind, "per_dtype": per_dtype,
                "bytes": float(sum(b for _, _, b in self.records)),
                "ops": len(self.records)}
