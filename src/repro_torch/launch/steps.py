"""Train / prefill / decode step functions for the LM architectures —
counterpart of ``repro/launch/steps.py``.  PyTorch runs eagerly, so the
steps are plain closures where the JAX package jits them."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.layout import maybe_shard
from repro_torch.models.transformer import decode_step, lm_loss, prefill
from repro_torch.train.optim import (Optimizer, adamw, apply_updates,
                                     clip_by_global_norm, tree_leaves,
                                     tree_map)

_DP = ("pod", "data")


def make_optimizer(cfg: ArchConfig, lr: float = 3e-4) -> Optimizer:
    """AdamW with weight decay 0.1 and the config's moment dtype (f32
    moments beside bf16 weights in every full-size config)."""
    return adamw(lr, weight_decay=0.1,
                 moment_dtype=torch_dtype(cfg.moment_dtype))


def _or_zeros(g, p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


def loss_and_grads(params, cfg: ArchConfig, batch: dict):
    """``(loss, parts, grads)``: :func:`lm_loss` and its gradient tree by
    autograd (``jax.value_and_grad(lm_loss, has_aux=True)``), the loss
    and parts detached; an unused leaf gets a zero gradient, as
    ``jax.grad`` gives it.  ``params`` is not written."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, parts = lm_loss(leaves, cfg, batch)
        got = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                       allow_unused=True))
    # tree_map visits the leaves in tree_leaves order
    grads = tree_map(lambda p: _or_zeros(next(got), p), leaves)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    clip: float = 1.0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` over a dict of leaf tensors: gradients of :func:`lm_loss`
    by autograd, clipped to global norm ``clip``, then one optimiser
    update.  ``metrics`` holds 0-d device tensors (``loss``, ``ce``,
    ``moe_aux``, ``grad_norm``); nothing in the step waits for the card.
    The inputs are not written: the step returns new trees."""
    def train_step(params, opt_state, batch):
        loss, parts, grads = loss_and_grads(params, cfg, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads                 # freed before the new params are made
        params = apply_updates(params, updates)
        metrics = {"loss": loss, "ce": parts["ce"],
                   "moe_aux": parts["moe_aux"], "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: int | None = None):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``serve_step(params, batch, cache) -> (greedy token [B] int32,
    logits [B, V], cache)``.  On a mesh the token is taken from logits
    whose vocab dim is gathered first (at most ``[B, V]`` a step), so it
    is the unsharded ``argmax``: the lower index first on ties, as
    ``jnp.argmax``."""
    def serve_step(params, batch, cache):
        logits, new_cache = decode_step(params, cfg, batch, cache)
        whole = maybe_shard(logits, _DP, None)
        next_tok = whole.argmax(dim=-1).to(torch.int32)
        return next_tok, logits, new_cache
    return serve_step
