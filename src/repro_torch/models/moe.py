"""Mixture-of-Experts FFN with grouped capacity dispatch — counterpart of
``repro/models/moe.py``.

Covers the registry's three MoE shapes: qwen2-moe-a2.7b (60 routed
experts top-4, padded to 64, + 4 shared), llama4-maverick (128 top-1 + 1
shared, MoE every other layer) and jamba-1.5-large (16 top-2).

The dispatch is the JAX package's step for step.  Tokens split into
``G`` groups, each with its own per-expert capacity ``C = max(int(S_g ·
K · cf / E), 4)``.  A token's ``K`` choices take slots in token-major
order (an exclusive cumsum over the group's flattened ``[S_g · K]``
choices); a choice whose slot reaches ``C`` is dropped: it scatters zeros
into slot ``C − 1`` and combines with weight 0, so the residual stream
carries that token unchanged.  The buffers keep the ``[G, E_pad, C, d]``
layout: :func:`repro_torch.layout.dispatch_groups` sets ``G`` to the
data-parallel degree inside an ``activation_sharding`` context, where the
JAX package's sharding hints (:func:`~repro_torch.layout.maybe_shard`)
lay the buffers out group-sharded around the dispatch and expert-sharded
around the expert products; on one card ``G = 1`` and the hints are the
identity.

Two details decide which choices are kept, and the port matches them
bit for bit: the router logits are rounded to the activation dtype before
the f32 softmax (``(x @ router).float()``), and the top-k takes the
lower expert index first on ties (a stable descending sort, as
``jax.lax.top_k``).  The expert products are plain ``torch.matmul``
over the stacked ``[E_pad, d, f]`` weights — the JAX package computes
them outside any Pallas kernel — and the scatter and gather are plain
indexing; the down projection returns the activation dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.layout import dispatch_groups, maybe_shard
from repro_torch.models import layers as L

_DP = ("pod", "data")


def init_moe(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
             ) -> dict:
    """Router ``[d, E]``, stacked experts ``w_gate``/``w_up`` ``[E_pad,
    d, f]`` and ``w_down`` ``[E_pad, f, d]``, and the shared experts' gated
    MLP, with the JAX package's scales and leading (stacked-block) dims
    ``lead``."""
    m = cfg.moe
    d, dt = cfg.d_model, cfg.pdtype
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(m.d_expert)
    p = {
        "router": L.normal(gen, (*lead, d, m.n_experts), dt, s_in),
        "w_gate": L.normal(gen, (*lead, m.e_padded, d, m.d_expert), dt,
                           s_in),
        "w_up": L.normal(gen, (*lead, m.e_padded, d, m.d_expert), dt, s_in),
        "w_down": L.normal(gen, (*lead, m.e_padded, m.d_expert, d), dt,
                           s_out),
    }
    if m.n_shared:
        p["shared"] = L.init_mlp(gen, d, m.shared_hidden, dt, lead)
    return p


def group_capacity(m: MoEConfig, group_tokens: int) -> int:
    """Slots per expert and group: ``max(int(S_g · K · cf / E), 4)``."""
    cap = int(group_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(cap, 4)


def route(params: dict, m: MoEConfig, xt: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router softmax ``probs`` [T, E] (f32), the renormalised top-k gate
    values [T, K] and expert indices [T, K] (int64), lower index first on
    ties."""
    logits = (xt @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :m.top_k], expert_idx[:, :m.top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, expert_idx


def slots(expert_idx: torch.Tensor, m: MoEConfig, groups: int, cap: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each choice's expert ``fe`` [G, S_g·K], its slot ``pos`` and ``keep
    = pos < cap``.  ``pos`` is the number of earlier choices of the same
    expert in the group's token-major order — the JAX package's
    exclusive cumsum over one-hot rows — found as each choice's rank
    within its expert after a stable sort by expert."""
    fe = expert_idx.reshape(groups, -1)
    order = torch.sort(fe, dim=1, stable=True).indices
    counts = torch.zeros((groups, m.e_padded), dtype=fe.dtype,
                         device=fe.device).scatter_add_(
                             1, fe, torch.ones_like(fe))
    starts = torch.cumsum(counts, dim=1) - counts               # [G, E]
    sorted_pos = torch.arange(fe.shape[1], device=fe.device) - \
        torch.gather(starts, 1, torch.gather(fe, 1, order))
    pos = torch.empty_like(fe).scatter_(1, order, sorted_pos)
    return fe, pos, pos < cap


def flat_rows(fe: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
              e_pad: int, cap: int) -> torch.Tensor:
    """Each choice's (expert, slot) as a row of the flattened ``[G·E_pad·
    C]`` buffer; a dropped choice points at slot ``C − 1`` of its expert,
    as in the JAX package."""
    base = torch.arange(fe.shape[0], device=fe.device)[:, None] * e_pad
    return (base + fe) * cap + torch.where(keep, pos, cap - 1)


def dispatch(xt: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor,
             k: int, n_rows: int) -> torch.Tensor:
    """The flattened dispatch buffer ``[G·E_pad·C, d]``: each kept
    choice's token row in its slot, zeros in the slots no choice took.
    Built as a gather (each slot reads its token, or a zero row), so no
    two writes meet; the values equal the JAX package's scatter-add,
    where dropped choices add zeros."""
    n_tok, d = xt.shape
    token = torch.full((n_rows + 1,), n_tok, dtype=rows.dtype,
                       device=rows.device)
    token.scatter_(0, torch.where(keep, rows, n_rows).reshape(-1),
                   torch.arange(rows.numel(), device=rows.device) // k)
    padded = torch.cat([xt, xt.new_zeros((1, d))])
    return padded.index_select(0, token[:n_rows])


def experts(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU over every (padded) expert's slots:
    ``[G, E_pad, C, d]`` in, the same shape and dtype out."""
    hid = maybe_shard(F.silu(buf @ params["w_gate"]) * (buf @ params["w_up"]),
                      None, _DP, None, "model")
    return (hid @ params["w_down"]).to(buf.dtype)


def combine(out_rows: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor,
            gate_vals: torch.Tensor, k: int) -> torch.Tensor:
    """Gather each choice's expert output row, weight it by its gate value
    (0 if dropped) and sum a token's ``k`` choices: ``[G · S_g, d]``."""
    d = out_rows.shape[-1]
    w = torch.where(keep, gate_vals.reshape(keep.shape), 0.0) \
        .to(out_rows.dtype)
    contrib = out_rows.index_select(0, rows.reshape(-1)) * w.reshape(-1, 1)
    return contrib.reshape(-1, k, d).sum(dim=1)


def moe_ffn(params: dict, cfg: ArchConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over ``x`` [B, S, d] in :func:`dispatch_groups` token
    groups (one where they do not divide the tokens); returns ``(out [B,
    S, d] in x's dtype, router aux loss (f32 scalar))``."""
    m = cfg.moe
    b, s, d = x.shape
    n_tok = b * s
    g = dispatch_groups()
    if n_tok % g:
        g = 1
    xt = x.reshape(n_tok, d)
    # d unsharded at the MoE's entry
    xt = maybe_shard(xt, _DP, None)

    probs, gate_vals, expert_idx = route(params, m, xt)
    # load-balancing auxiliary loss (Switch/GShard), global statistics
    counts = torch.bincount(expert_idx.reshape(-1), minlength=m.n_experts)
    ce_frac = counts.float() / (n_tok * m.top_k)
    aux = m.n_experts * torch.sum(probs.mean(0) * ce_frac) * \
        m.router_aux_weight

    cap = group_capacity(m, n_tok // g)
    fe, pos, keep = slots(expert_idx, m, g, cap)
    rows = flat_rows(fe, pos, keep, m.e_padded, cap)
    n_rows = g * m.e_padded * cap
    buf = dispatch(xt, rows, keep, m.top_k, n_rows)
    # group-sharded -> expert-sharded over the data axes: the dispatch
    # all-to-all; and back for the combine
    buf = maybe_shard(buf.view(g, m.e_padded, cap, d), None, _DP, None,
                      None)
    out_buf = maybe_shard(experts(params, buf), _DP, None, None, None)
    out = combine(out_buf.reshape(n_rows, d), rows, keep, gate_vals,
                  m.top_k)
    out = maybe_shard(out, _DP, None)
    if m.n_shared:
        out = out + L.mlp(params["shared"], xt, "swiglu")
    return out.reshape(b, s, d), aux
