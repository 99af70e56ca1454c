"""Prefill / decode step functions for the ported archs — counterpart of
``repro/launch/steps.py`` (serving only; the train step waits for the LM
training slice).  PyTorch runs eagerly, so the steps are plain closures
where the JAX package jits them."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import decode_step, prefill


def make_prefill_step(cfg: ArchConfig, max_len: int | None = None):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def serve_step(params, batch, cache):
        logits, new_cache = decode_step(params, cfg, batch, cache)
        next_tok = logits.argmax(dim=-1).to(torch.int32)
        return next_tok, logits, new_cache
    return serve_step
