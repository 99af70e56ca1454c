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
around the expert products (on ``DTensor`` activations each rank routes,
dispatches and combines its own group, and multiplies its own experts,
under ``local_map``); on one card ``G = 1`` and the hints are the
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
from repro_torch.layout import (_is_dtensor, dispatch_groups, maybe_shard,
                                replicate_like)
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


def choice_counts(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many of the choices ``expert_idx`` [T, K] picked each expert:
    [E] int64 (``torch.bincount``, written as a scatter-add, which runs on
    a rank's local shard of a mesh)."""
    flat = expert_idx.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))


def _on_groups(xt: torch.Tensor):
    """``on_groups(fn, outs, grads=None)``: ``fn`` run on each rank's own
    token groups where ``xt`` (the MoE's tokens ``[T, d]``) is a
    ``DTensor``, else ``fn`` itself.

    On a mesh the tokens are split over the data axes with one group a
    rank (or replicated, as one group, where the groups do not divide
    them), so the routing, slots, dispatch and combine are each rank's
    own work: ``fn`` runs under ``local_map`` on the local shards.  Each
    entry of ``outs`` lays out one output: ``"rows"`` group-major like
    ``xt``, ``"sum"`` a per-rank partial sum over the data axes.
    ``grads`` gives each input's gradient layout the same way (default:
    its own; a replicated weight that meets the local tokens has
    ``"sum"``)."""
    if not _is_dtensor(xt):
        return lambda fn, outs, grads=None: fn

    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    rows = tuple(xt.placements)
    kinds = {"rows": rows,
             "sum": tuple(Partial() if p.is_shard() else Replicate()
                          for p in rows)}

    def on_groups(fn, outs, grads=None):
        return local_map(
            fn, out_placements=tuple(kinds[o] for o in outs),
            in_grad_placements=None if grads is None else
            tuple(kinds[gr] for gr in grads),
            device_mesh=xt.device_mesh)
    return on_groups


def _run_experts(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """:func:`experts` over ``buf``, on each rank's own experts where
    ``buf`` is a ``DTensor``.

    On a mesh ``buf`` is expert-sharded over the data axes; the weights
    are laid out to match (the expert dim on the same mesh dims, the
    hidden dim ``d_expert`` over ``model`` where the rules split it) and
    each rank multiplies its local slices, as GSPMD partitions the
    einsums.  Where ``d_expert`` is split the down projection yields a
    partial sum over those ranks, and the gradient of ``buf`` is one too.
    """
    if not _is_dtensor(buf):
        return experts(params, buf)

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    w = {k: params[k] if _is_dtensor(params[k]) else
         replicate_like(params[k], buf) for k in ("w_gate", "w_up", "w_down")}
    w_in, w_down, buf_grad, out = [], [], [], []
    for i, p in enumerate(buf.placements):
        if p.is_shard(1):                       # experts over this dim
            w_in.append(Shard(0))
            w_down.append(Shard(0))
            buf_grad.append(p)
            out.append(p)
        elif w["w_gate"].placements[i].is_shard(2):        # d_expert
            w_in.append(Shard(2))
            w_down.append(Shard(1))
            buf_grad.append(Partial())
            out.append(Partial())
        else:
            w_in.append(Replicate())
            w_down.append(Replicate())
            buf_grad.append(p)
            out.append(p)
    run = local_map(
        lambda wg, wu, wd, b: experts(
            {"w_gate": wg, "w_up": wu, "w_down": wd}, b),
        out_placements=(out,),
        in_placements=(w_in, w_in, w_down, buf.placements),
        in_grad_placements=(w_in, w_in, w_down, buf_grad),
        device_mesh=buf.device_mesh, redistribute_inputs=True)
    return run(w["w_gate"], w["w_up"], w["w_down"], buf)


def moe_ffn(params: dict, cfg: ArchConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over ``x`` [B, S, d] in :func:`dispatch_groups` token
    groups (one where they do not divide the tokens); returns ``(out [B,
    S, d] in x's dtype, router aux loss (f32 scalar))``.

    On ``DTensor`` activations inside ``activation_sharding`` each rank
    routes, dispatches and combines its own group (:func:`_on_groups`);
    the router statistics of the aux loss are summed over the data axes,
    and the buffers move between group- and expert-sharded by
    :func:`~repro_torch.layout.maybe_shard` (the dispatch and combine
    all-to-alls)."""
    m = cfg.moe
    b, s, d = x.shape
    n_tok = b * s
    g = dispatch_groups()
    if n_tok % g:
        g = 1
    sg = n_tok // g
    cap = group_capacity(m, sg)
    xt = x.reshape(n_tok, d)
    # d unsharded at the MoE's entry
    xt = maybe_shard(xt, _DP, None)
    on_groups = _on_groups(xt)

    probs, gate_vals, expert_idx = on_groups(
        lambda router, t: route({"router": router}, m, t),
        ("rows", "rows", "rows"), grads=("sum", "rows"))(
            params["router"], xt)
    # load-balancing auxiliary loss (Switch/GShard), global statistics
    counts = on_groups(lambda e: choice_counts(e, m.n_experts),
                       ("sum",))(expert_idx)
    ce_frac = counts.float() / (n_tok * m.top_k)
    aux = m.n_experts * torch.sum(probs.mean(0) * ce_frac) * \
        m.router_aux_weight

    def assign(idx):
        fe, pos, keep = slots(idx, m, idx.shape[0] // sg, cap)
        return flat_rows(fe, pos, keep, m.e_padded, cap), keep

    def send(t, rows, keep):
        n = rows.shape[0] * m.e_padded * cap
        return dispatch(t, rows, keep, m.top_k, n).view(
            rows.shape[0], m.e_padded, cap, d)

    rows, keep = on_groups(assign, ("rows", "rows"))(expert_idx)
    buf = on_groups(send, ("rows",))(xt, rows, keep)
    # group-sharded -> expert-sharded over the data axes: the dispatch
    # all-to-all; and back for the combine
    buf = maybe_shard(buf, None, _DP, None, None)
    out_buf = maybe_shard(_run_experts(params, buf), _DP, None, None, None)
    out = on_groups(lambda ob, r, k, gv: combine(
        ob.reshape(-1, d), r, k, gv, m.top_k), ("rows",))(
            out_buf, rows, keep, gate_vals)
    out = maybe_shard(out, _DP, None)
    if m.n_shared:
        out = out + L.mlp(params["shared"], xt, "swiglu")
    return out.reshape(b, s, d), aux
