"""Optimisers and LR schedules over plain parameter trees.

Counterpart of ``repro/train/optim.py``.  An :class:`Optimizer` is the
``(init, update)`` pair over trees of tensors (dicts, lists and tuples;
``None`` leaves stay ``None``), and every update is written term for term
as the JAX package writes it, so the two round alike.  No ``torch.optim``
class is used: ``torch.optim.AdamW`` applies the weight decay and the
bias-corrected denominator in another order.

The step counter stays a 0-d int32 CPU tensor, so the bias corrections
and LR schedules are host scalars that never wait on the device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def tree_leaves(tree) -> list:
    """Tensor leaves in sorted-key / sequence order (``None`` dropped) —
    ``jax.tree_util.tree_leaves``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(f, tree, *rest):
    """``f`` over matching leaves of trees of one structure, visited in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else f(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def sgd(lr: float | Callable, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(), "mom": mom}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr_fn(step)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads,
                             params)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state["mom"],
                           grads)
            upd = tree_map(lambda m: -eta * m, mom)
        else:
            mom = None
            upd = tree_map(lambda g: -eta * g, grads)
        return upd, {"step": step, "mom": mom}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          moment_dtype: torch.dtype | None = None) -> Optimizer:
    """AdamW (``repro/train/optim.py:75-121``): the moments are stored in
    ``moment_dtype`` (default: each parameter's own dtype) and updated in
    float32; ``moment_dtype=torch.bfloat16`` halves the optimiser's
    memory, ``torch.float32`` keeps f32 moments beside bf16 weights."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def zeros(p):
        return torch.zeros_like(p, dtype=moment_dtype or p.dtype)

    def init(params):
        return {"step": _step0(), "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(torch.float32)
        eta = lr_fn(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def leaf(g, mu, nu, p):
            gf = g.float()
            mu_f = b1 * mu.float() + (1 - b1) * gf
            nu_f = b2 * nu.float() + (1 - b2) * gf * gf
            u = -eta * (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + eps)
            if weight_decay:
                u = u - eta * weight_decay * p.float()
            dt = moment_dtype or p.dtype
            return u.to(p.dtype), mu_f.to(dt), nu_f.to(dt)

        out = tree_map(leaf, grads, state["mu"], state["nu"], params)
        pick = (lambda i: tree_map(lambda _, o: o[i], grads, out))
        return pick(0), {"step": step, "mu": pick(1), "nu": pick(2)}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# LR schedules (float32 CPU scalars)
# ---------------------------------------------------------------------------


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def constant_lr(v: float) -> Callable:
    return lambda _step: _f32(v)


def cosine_lr(peak: float, total_steps: int, warmup: int = 0,
              floor: float = 0.0) -> Callable:
    def fn(step):
        s = _f32(step)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return fn


def linear_decay_lr(peak: float, total_steps: int, warmup: int = 0
                    ) -> Callable:
    def fn(step):
        s = _f32(step)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        return torch.where(s < warmup, warm, peak * (1.0 - frac))
    return fn


OPTIMIZERS = {"adamw": adamw, "sgd": sgd}
