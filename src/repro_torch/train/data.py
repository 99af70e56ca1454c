"""Synthetic token pipeline for LM training — counterpart of
``repro/train/data.py``.

A deterministic, seedable stream of batches with learnable structure: a
power-law unigram prior composed with a sparse bigram transition.  The
numpy draws are the JAX package's, call for call, so the tokens are
bitwise the same; each batch lands on ``device`` as int32.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.transformer import checked_device


@dataclasses.dataclass
class TokenPipeline:
    """``next(pipe) -> {"tokens": int32 [batch, seq_len] on device}``.

    Example::

        pipe = TokenPipeline(cfg.vocab_size, batch=8, seq_len=2048)
        batch = next(pipe)
    """
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    branch: int = 8          # bigram fan-out
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = checked_device(self.device)
        rng = np.random.default_rng(self.seed)
        # sparse bigram table: each token has `branch` successors with
        # dirichlet weights
        self._succ = rng.integers(0, self.vocab_size,
                                  (self.vocab_size, self.branch))
        w = rng.dirichlet(np.ones(self.branch) * 0.5, self.vocab_size)
        self._w = w.astype(np.float64)
        self._step = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + self._step)
        self._step += 1
        toks = np.zeros((self.batch, self.seq_len), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, self.batch)
        # vectorised bigram walk
        for t in range(1, self.seq_len):
            u = rng.random(self.batch)
            cum = np.cumsum(self._w[toks[:, t - 1]], axis=1)
            choice = (u[:, None] < cum).argmax(axis=1)
            toks[:, t] = self._succ[toks[:, t - 1], choice]
        return {"tokens": torch.from_numpy(toks.astype(np.int32))
                .to(self.device)}
