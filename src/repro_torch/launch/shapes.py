"""Assigned input shapes and the model-input stand-ins — counterpart of
``repro/launch/shapes.py``.

The four assigned shapes:

    train_4k     seq 4,096    global_batch 256   (training)
    prefill_32k  seq 32,768   global_batch 32    (inference prefill)
    decode_32k   seq 32,768   global_batch 128   (decode: 1 new token, KV=32k)
    long_500k    seq 524,288  global_batch 1     (long-context decode)

:func:`batch_specs` gives every model input as a tensor on the ``meta``
device (shape and dtype, no storage; the JAX package's
``ShapeDtypeStruct``) — tokens for LM archs, precomputed patch embeddings
and M-RoPE ids for the VLM (frontend stub), codec token ids for the audio
arch; ``concrete=True`` draws the JAX package's small ``default_rng(0)``
arrays instead, on ``device``.  :func:`cache_specs` is ``init_cache`` on
the meta device (or, concrete, on ``device``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import checked_device


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def batch_specs(cfg: ArchConfig, shape: InputShape, concrete: bool = False,
                batch: int | None = None, seq: int | None = None,
                device="cuda") -> dict:
    """Model-input dict for ``(cfg, shape)``: meta tensors, or with
    ``concrete`` seeded arrays on ``device`` (each drawn from a fresh
    ``default_rng(0)``: integers in ``[0, maxval)``, floats N(0, 0.02)
    rounded to float32 and then to the activation dtype)."""
    b = batch or shape.global_batch
    s = 1 if shape.kind == "decode" else (seq or shape.seq_len)
    if concrete:
        device = checked_device(device)

    def mk(shp, dtype, maxval=None):
        if not concrete:
            return torch.empty(shp, dtype=dtype, device="meta")
        rng = np.random.default_rng(0)
        if not dtype.is_floating_point:
            a = torch.from_numpy(rng.integers(0, maxval or 2, shp))
        else:
            a = torch.from_numpy(rng.normal(0, 0.02, shp).astype(np.float32))
        return a.to(device=device, dtype=dtype)

    specs: dict = {}
    if cfg.embed_source == "patches":
        # VLM stub frontend: pre-projected patch embeddings + M-RoPE ids
        specs["embeds"] = mk((b, s, cfg.d_model), cfg.adtype)
        specs["labels"] = mk((b, s), torch.int32, cfg.vocab_size)
        specs["positions3"] = mk((3, b, s), torch.int32, max(s, 2))
        specs["positions"] = mk((b, s), torch.int32, max(s, 2))
    else:
        specs["tokens"] = mk((b, s), torch.int32, cfg.vocab_size)
    return specs


def cache_specs(cfg: ArchConfig, shape: InputShape, concrete: bool = False,
                batch: int | None = None, cache_len: int | None = None,
                device="cuda"):
    """The decode cache for ``(cfg, shape)``: ``init_cache`` on the meta
    device, or with ``concrete`` on ``device``."""
    from repro_torch.models.transformer import init_cache

    b = batch or shape.global_batch
    n = cache_len or shape.seq_len
    return init_cache(cfg, b, n, device=device if concrete else "meta")


def long_context_variant(cfg: ArchConfig, window: int = 8192) -> ArchConfig:
    """SWA variant used for ``long_500k`` on attention-bearing archs.

    SSM archs pass through unchanged (already O(1) decode); archs with
    attention layers get a sliding window so the KV cache is bounded —
    the carve-out that lets dense archs run 524k decode.
    """
    if cfg.family == "ssm" or cfg.sliding_window:
        return cfg
    return cfg.with_(sliding_window=window)
