"""The LM stack's serving path — counterpart of ``repro/models``:
:mod:`.layers` (attention, RoPE, gated MLP), :mod:`.mamba2` (SSD),
:mod:`.moe` (the MoE FFN) and :mod:`.transformer` (``init_lm``,
``prefill``, ``decode_step``) — and
:func:`lm_params_from_jax`, which carries JAX weights across."""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a)                  # writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: reinterpret the 16 bits
        t = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_jax(tree, device="cuda"):
    """Turn a JAX ``init_lm`` pytree whose leaves the caller converted to
    numpy (``jax.tree_util.tree_map(np.asarray, params)``) into the port's
    dict of tensors on ``device``: same keys and layout (block leaves
    stacked ``[n_blocks, ...]``), same dtype and bits (bf16 leaves
    included)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(lm_params_from_jax(v, device) for v in tree)
    return _leaf(tree, device)


__all__ = ["lm_params_from_jax"]
