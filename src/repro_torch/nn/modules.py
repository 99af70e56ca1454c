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


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise the last dim to zero mean and unit (population)
    variance; no scale or shift."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with the ``(1 + gamma)`` scale, computed in f32 whatever
    the activation dtype and cast back to it."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * scale) * (1.0 + gamma.float())).to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Per-example CE against integer labels (stable log-softmax).  The
    gold logit is subtracted before its gathered dim is dropped: on
    vocab-sharded DTensor logits the gather's masked partial sum must be
    reduced at the gather's rank."""
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    gold = torch.gather(logits, -1, labels[..., None].long())
    return (logz - gold)[..., 0]


def param_count(params) -> int:
    """Number of scalars in a (nested dict/list/tuple) parameter tree."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return 0 if params is None else params.numel()
