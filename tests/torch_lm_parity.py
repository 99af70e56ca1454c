"""Shared pieces of the LM training slice's parity tests
(``tests/test_torch_lm_train.py``, ``tests/test_torch_lm_train_paths.py``):
the JAX package's smoke configs and weights carried into the port, seeded
batches, the port's loss gradients and the leafwise closeness rule."""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget
from repro.models import transformer as JT
from repro_torch.configs.base import get_config as tget
from repro_torch.models import lm_params_from_jax
from repro_torch.models import transformer as TT
from repro_torch.train.optim import tree_leaves, tree_map

from torch_dist_cases import one_thread

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LR = 3e-3
ARCHS = ["granite-3-2b", "mamba2-130m", "gemma-7b", "yi-6b", "qwen3-32b",
         "qwen2-vl-2b", "musicgen-large", "qwen2-moe-a2.7b",
         "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]
assert sorted(ARCHS) == sorted(ARCH_IDS)


@functools.lru_cache(maxsize=None)
def _setup(arch, **over):
    """Configs and weights, shared by the tests (none writes them)."""
    jc = jget(arch, smoke=True).with_(**over)
    tc = tget(arch, smoke=True).with_(**over)
    jp = jax.jit(JT.init_lm, static_argnums=1)(jax.random.key(0), jc)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _batches(cfg, b, s, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if mask:
        m = (rng.uniform(size=(b, s)) < 0.7).astype(np.float32)
        jb["loss_mask"], tb["loss_mask"] = jnp.asarray(m), torch.from_numpy(m)
    return jb, tb


def _seq(cfg) -> int:
    # two SSD chunks where the config has mamba layers (the inter-chunk
    # recurrence runs), else 64 tokens
    return 2 * cfg.mamba.chunk if "mamba" in cfg.pattern else 64


def _port_grads(tp, tc, tb):
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(True), tp)
    loss, parts = TT.lm_loss(leaves, tc, tb)
    grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                allow_unused=True)
    return loss, parts, [torch.zeros_like(p) if g is None else g
                         for p, g in zip(tree_leaves(leaves), grads)]


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


#: the SSD's per-head leaves whose gradients cancel (module docstring)
CANCELLING = ("A_log", "dt_bias")


def _rel_close(got, want, tol=TOL):
    """Leafwise: |got - want| ≤ tol · max|want| (1e-4 for the leaves in
    :data:`CANCELLING`)."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(got)
    for (path, a), b in zip(flat, got):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        name = jax.tree_util.keystr(path)
        t = max(tol, 1e-4) if name.endswith(
            tuple(f"['{c}']" for c in CANCELLING)) else tol
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= t * scale, (name, err, scale)


def _metrics_close(jm, tm, tol=TOL):
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                   atol=tol, err_msg=k)


@pytest.fixture(autouse=True, scope="module")
def port_on_one_thread():
    """The port's side of these tests runs on one CPU thread, as the
    worker-backend tests run theirs (``torch_dist_cases.one_thread``):
    at these small shapes more threads buy nothing, and when parallel
    test workers together ask for more threads than the machine has
    cores, their synchronisation multiplies each test's time."""
    with one_thread():
        yield
