"""The LM stack — counterpart of ``repro/models``:
:mod:`.layers` (attention, RoPE, gated MLP), :mod:`.mamba2` (SSD),
:mod:`.moe` (the MoE FFN) and :mod:`.transformer` (``init_lm``,
``prefill``, ``decode_step``, ``forward_train``, ``lm_loss``) — and
:func:`lm_params_from_jax` / :func:`adamw_state_from_jax`, which carry
JAX weights and optimiser state across."""

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


def adamw_state_from_jax(state, device="cuda") -> dict:
    """The JAX package's AdamW state ``{"step", "mu", "nu"}`` (leaves
    converted to numpy by the caller) as the port's: the step a 0-d int32
    CPU tensor (the port's optimisers keep it on the host), the moments
    through :func:`lm_params_from_jax` in their own dtype."""
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32),
            "mu": lm_params_from_jax(state["mu"], device),
            "nu": lm_params_from_jax(state["nu"], device)}


__all__ = ["adamw_state_from_jax", "lm_params_from_jax"]
