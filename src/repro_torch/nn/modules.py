"""Minimal functional building blocks over plain dict parameters.

Parameters are dicts of tensors with the JAX package's layout — a dense
layer is ``{"w": [d_in, d_out], "b": [d_out]}`` applied as ``x @ w + b`` —
so weights carry over from JAX unchanged (:func:`repro_torch.nn.gnn.
params_from_jax`).
"""

from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True, scale: float = 1.0,
               device="cuda") -> dict:
    """LeCun fan-in normal init, drawn on the CPU from ``generator`` (so
    the weights do not depend on the device) and moved to ``device``."""
    std = scale / math.sqrt(d_in)
    p = {"w": (torch.randn((d_in, d_out), generator=generator) * std)
         .to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y
