"""Unified decoder — counterpart of ``repro/models/transformer.py``, the
serving entry points.

A model is ``n_blocks`` repetitions of a *pattern* (a tuple of layer
kinds: ``("attn",)`` for dense LMs, ``("mamba",)`` for mamba2,
``("mamba", "attn")`` and the like for hybrids); each layer's FFN is the
gated MLP or, where ``cfg.layer_uses_moe``, the MoE FFN of
:mod:`repro_torch.models.moe`.  The parameters keep the JAX layout —
every block leaf stacked ``[n_blocks, ...]`` — and the blocks run in a
Python loop over that leading dim, so weights carry over from JAX
unchanged (:func:`repro_torch.models.lm_params_from_jax`).  The JAX
package's sharding hints sit at its places as
:func:`repro_torch.layout.maybe_shard` calls: inside
:func:`~repro_torch.layout.activation_sharding` they redistribute
DTensor activations over a device mesh (the dry run,
:mod:`repro_torch.launch.dryrun`); on plain tensors, as on one card,
they are the identity.

Entry points:

* :func:`prefill`     — forward over a prompt, returning last-position
  logits and a populated :class:`Cache`; attention runs the
  ``flash_attention`` kernel, mamba layers the ``ssd_chunk`` kernel.
* :func:`decode_step` — one-token serve step against a Cache (O(1) for
  SSM layers; ring-buffer sliding-window or full causal for attention),
  plain torch.  It writes the new KV entries and states into the cache's
  tensors **in place** (a full-size KV cache is gigabytes; the JAX
  package returns a new one) and returns a Cache over the same tensors.

* :func:`forward_train` / :func:`lm_loss` — the training forward and
  next-token CE (+ the MoE router aux loss).  They run what the JAX
  package's training forward runs, in plain torch with autograd:
  :func:`chunked_sdpa` (online softmax over query and key chunks) where the
  JAX package takes it (S ≥ 2048, S % 1024 == 0, no M-RoPE) and
  :func:`repro_torch.models.layers.sdpa` otherwise, and the einsum form of
  the SSD scan (:func:`repro_torch.models.mamba2.ssd_chunked` with
  ``train=True``).  Neither CUDA kernel has a backward, so the training
  path reaches neither; ``train=True``, threaded through
  :func:`_apply_block` and :func:`_mixer`, picks it.  With ``cfg.remat``
  every block runs under ``torch.utils.checkpoint`` (the counterpart of
  ``jax.checkpoint``): only block-boundary activations live across the
  backward.

Every architecture of the registry is served and trained; the MoE
layers' router aux loss is summed per block, discarded by the serving
entry points and added to the loss by :func:`lm_loss`, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.layout import maybe_shard, replicate_like, write_at
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (MambaCache, init_mamba,
                                       init_mamba_cache, mamba_layer)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.nn.modules import rms_norm, softmax_cross_entropy


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention for long training sequences
# ---------------------------------------------------------------------------


#: the data-parallel axis group of the sharding hints
_DP = ("pod", "data")


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int, q_chunk: int = 512, kv_chunk: int = 1024
                 ) -> torch.Tensor:
    """Online-softmax causal attention in plain torch (the JAX package's
    ``chunked_sdpa``, ``repro/models/transformer.py:45-122``); peak memory
    O(q_chunk × kv_chunk) per (query chunk, key chunk) pair, and autograd
    keeps each pair's scores for the backward.

    q: [B, S, H, D], k/v: [B, S, KV, D] (same length, causal, optional
    sliding window).  GQA repeats each key/value chunk to H heads.  The
    score products run in q's dtype and the softmax statistics in f32, as
    the JAX package computes them.  Key chunks that the causal or window
    mask hides from a whole query chunk are skipped: in the JAX scan they
    add ``exp(f32 min - m) = 0`` to every sum, so the result is the same.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunks ({q_chunk}, {kv_chunk})")
    scale = 1.0 / math.sqrt(d)
    neg = torch.finfo(torch.float32).min
    q = maybe_shard(q, _DP, None, "model", None)
    outs = []
    for q0 in range(0, s, q_chunk):
        q_blk = q[:, q0:q0 + q_chunk].transpose(1, 2)        # [B,H,Qc,D]
        q_blk = maybe_shard(q_blk, _DP, "model", None, None)
        q_pos = torch.arange(q0, q0 + q_chunk, device=q.device)
        m_run = torch.full((b, h, q_chunk), neg, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, h, q_chunk), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, s, kv_chunk):
            if k0 > q0 + q_chunk - 1:                       # all in future
                continue
            if window > 0 and k0 + kv_chunk - 1 <= q0 - window:
                continue                                    # all too old
            k_pos = torch.arange(k0, k0 + kv_chunk, device=q.device)
            krep = k[:, k0:k0 + kv_chunk].repeat_interleave(group, dim=2)
            vrep = v[:, k0:k0 + kv_chunk].repeat_interleave(group, dim=2)
            krep = maybe_shard(krep, _DP, None, "model", None)
            vrep = maybe_shard(vrep, _DP, None, "model", None)
            scores = torch.einsum("bhqd,bshd->bhqs", q_blk,
                                  krep).float() * scale
            scores = maybe_shard(scores, _DP, "model", None, None)
            mask = k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > (q_pos[:, None] - window)
            scores = torch.where(mask[None, None], scores, neg)
            m_new = torch.maximum(m_run, scores.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(scores - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(q.dtype), vrep).float()
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-20)[..., None]
        outs.append(out.to(q.dtype).transpose(1, 2))        # [B,Qc,H,D]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


class AttnCache(NamedTuple):
    """Ring-buffer KV cache: ``pos`` holds absolute positions (-1 empty)."""
    k: torch.Tensor       # [B, W, KV, D]
    v: torch.Tensor       # [B, W, KV, D]
    pos: torch.Tensor     # [B, W] int32


class Cache(NamedTuple):
    """Per-pattern-position caches, each stacked over n_blocks."""
    layers: tuple   # tuple over pattern idx of AttnCache | MambaCache
    index: int      # number of tokens already in the cache


def checked_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "asked for a CUDA device but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Cache:
    device = checked_device(device)
    dtype = dtype or cfg.adtype
    nb = cfg.n_blocks
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    per = []
    for kind in cfg.pattern:
        if kind == "attn":
            per.append(AttnCache(
                k=torch.zeros((nb, batch, w, kv, hd), dtype=dtype,
                              device=device),
                v=torch.zeros((nb, batch, w, kv, hd), dtype=dtype,
                              device=device),
                pos=torch.full((nb, batch, w), -1, dtype=torch.int32,
                               device=device)))
        else:
            per.append(init_mamba_cache(cfg, batch, dtype, device,
                                        lead=(nb,)))
    return Cache(layers=tuple(per), index=0)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
                ) -> dict:
    """One pattern-period of layers (every leaf with leading dims
    ``lead``)."""
    block = {}
    dev = gen.device
    for pi, kind in enumerate(cfg.pattern):
        lp: dict = {"norm1": torch.zeros((*lead, cfg.d_model),
                                         dtype=cfg.pdtype, device=dev),
                    "norm2": torch.zeros((*lead, cfg.d_model),
                                         dtype=cfg.pdtype, device=dev)}
        if kind == "attn":
            lp["attn"] = L.init_attn(gen, cfg, lead)
        else:
            lp["mamba"] = init_mamba(gen, cfg, lead)
        if cfg.layer_uses_moe(pi):
            lp["moe"] = init_moe(gen, cfg, lead)
        elif cfg.d_ff > 0:
            lp["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype,
                                   lead)
        else:
            del lp["norm2"]     # mamba2-style blocks: mixer only, no FFN
        block[f"p{pi}_{kind}"] = lp
    return block


def init_lm(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
            device="cuda") -> dict:
    """Random weights in the JAX package's layout, drawn on ``device`` from
    ``generator`` (a ``torch.Generator`` on that device; seed 0 if
    omitted): block leaves are stacked ``[n_blocks, ...]``.  The numbers
    are not JAX's — parity runs carry JAX's weights across instead."""
    device = checked_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)
    if gen.device.type != device.type:
        raise ValueError(f"generator lives on {gen.device}, weights on "
                         f"{device}")
    params = {
        "embed": L.normal(gen, (cfg.vocab_size, cfg.d_model), cfg.pdtype,
                          0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                  device=device),
        "blocks": _init_block(gen, cfg, lead=(cfg.n_blocks,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab_size),
                                     cfg.pdtype, 0.02)
    return params


def _index(tree, i: int):
    """Block ``i`` of a tree of stacked leaves (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [_index(v, i) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else \
            tuple(parts)
    return tree[i]


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _attn_decode(params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache: AttnCache, cache_index: int,
                 positions3):
    """One-token decode against a (possibly ring-buffer) KV cache; writes
    the new entry into ``cache`` in place."""
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per row, got "
                         f"{x.shape[1]}")
    q, k, v = L.attn_qkv(params, cfg, x, positions, positions3)

    slot = cache_index % cache.k.shape[1]
    write_at(cache.k, 1, slot, k[:, 0].to(cache.k.dtype))
    write_at(cache.v, 1, slot, v[:, 0].to(cache.v.dtype))
    write_at(cache.pos, 1, slot, positions[:, 0].to(torch.int32))

    q_pos = positions[:, :1]                                   # [B, 1]
    valid = (cache.pos >= 0) & (cache.pos <= q_pos)
    if cfg.sliding_window:
        valid &= cache.pos > (q_pos - cfg.sliding_window)
    out = L.sdpa(q, cache.k, cache.v, valid[:, None, :])
    return L.out_project(out, params["wo"]).to(x.dtype), cache


def _train_attention(params: dict, cfg: ArchConfig, h: torch.Tensor,
                     positions: torch.Tensor, positions3) -> torch.Tensor:
    """The training forward's attention sublayer: :func:`chunked_sdpa`
    where the JAX package takes it, else the masked plain ``sdpa``."""
    q, k, v = L.attn_qkv(params, cfg, h, positions, positions3)
    if L.use_chunked_sdpa(cfg, h.shape[1], positions3):
        # k / v unsharded over S once a layer, heads over model
        q = maybe_shard(q, _DP, None, "model", None)
        k = maybe_shard(k, _DP, None, "model", None)
        v = maybe_shard(v, _DP, None, "model", None)
        out = chunked_sdpa(q, k, v, cfg.sliding_window)
    else:
        out = L.sdpa(q, k, v, L._attn_mask(positions, positions,
                                           cfg.sliding_window))
    return L.out_project(out, params["wo"]).to(h.dtype)


def _mixer(lp: dict, cfg: ArchConfig, pi: int, kind: str, h: torch.Tensor,
           positions: torch.Tensor, cache_layer, cache_index,
           positions3, mask_positions=None, train: bool = False
           ) -> tuple[torch.Tensor, object]:
    """Apply the token mixer (attention or mamba) for one layer; a prefill
    attention masks by ``mask_positions`` (None: by index).  ``train``
    runs the plain, differentiable path and returns no cache."""
    if train:
        if kind == "attn":
            return _train_attention(lp["attn"], cfg, h, positions,
                                    positions3), None
        return mamba_layer(lp["mamba"], cfg, h, train=True)[0], None
    if kind == "attn":
        if cache_layer is None:
            y, kvc = L.attention(lp["attn"], cfg, h, positions,
                                 positions3=positions3,
                                 mask_positions=mask_positions)
            return y, AttnCache(kvc.k.to(cfg.adtype), kvc.v.to(cfg.adtype),
                                positions.expand(h.shape[0], h.shape[1]))
        return _attn_decode(lp["attn"], cfg, h, positions, cache_layer,
                            cache_index, positions3)
    return mamba_layer(lp["mamba"], cfg, h, cache=cache_layer)


def _apply_block(block: dict, cfg: ArchConfig, h: torch.Tensor,
                 positions: torch.Tensor, block_cache: Optional[tuple],
                 cache_index, positions3, mask_positions=None,
                 train: bool = False
                 ) -> tuple[torch.Tensor, tuple, torch.Tensor]:
    """One pattern period: pre-norm mixer + pre-norm FFN (gated MLP or
    MoE) per layer; returns the MoE layers' summed router aux loss too.
    ``train`` selects the training forward's mixers (:func:`_mixer`)."""
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    decode = h.shape[1] == 1
    for pi, kind in enumerate(cfg.pattern):
        lp = block[f"p{pi}_{kind}"]
        cl = block_cache[pi] if block_cache is not None else None
        # sequence parallelism between layers: the residual stream over
        # model on the sequence dim (a decode step on d)
        h = maybe_shard(h, _DP, None, "model") if decode else \
            maybe_shard(h, _DP, "model", None)
        mixed, new_c = _mixer(lp, cfg, pi, kind, rms_norm(h, lp["norm1"]),
                              positions, cl, cache_index, positions3,
                              mask_positions, train)
        h = h + mixed
        if cfg.layer_uses_moe(pi):
            ffn_out, a = moe_ffn(lp["moe"], cfg, rms_norm(h, lp["norm2"]))
            aux = aux + a
            h = h + ffn_out
        elif cfg.d_ff > 0:
            h = h + L.mlp(lp["mlp"], rms_norm(h, lp["norm2"]), cfg.mlp)
        new_caches.append(new_c)
    return h, tuple(new_caches), aux


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _embed_in(params, cfg: ArchConfig, batch: dict
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if "embeds" in batch:                       # vlm / stubbed frontend
        x = batch["embeds"].to(cfg.adtype)
    else:
        x = params["embed"][batch["tokens"].long()].to(cfg.adtype)
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    return x, positions


def _lm_head(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"].T.to(h.dtype)
    return h @ params["lm_head"].to(h.dtype)


def _unstack(tree, n: int) -> list:
    """The ``n`` per-block trees of a tree of stacked leaves, by one
    ``unbind`` per leaf: the backward then stacks each leaf's gradient
    once instead of scattering every block's slice into a full-size
    zero tensor."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def forward_train(params, cfg: ArchConfig, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over the stacked blocks, no cache emission.

    Returns ``(hidden [B, S, d], moe_aux)``.  With ``cfg.remat`` each
    block runs under ``torch.utils.checkpoint`` (non-reentrant): only
    block-boundary activations survive the forward, and the backward
    recomputes each block (the MoE routing is a stable sort, so the
    recompute routes identically).
    """
    x, positions = _embed_in(params, cfg, batch)
    positions3 = batch.get("positions3")
    x = maybe_shard(x, _DP, "model", None)            # sequence parallel

    def block_fn(block, h):
        h, _, aux = _apply_block(block, cfg, h, positions, None, None,
                                 positions3, train=True)
        return h, aux

    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in _unstack(params["blocks"], cfg.n_blocks):
        if cfg.remat:
            h, a = checkpoint(block_fn, block, h, use_reentrant=False)
        else:
            h, a = block_fn(block, h)
        aux = aux + a
    return h, aux


def lm_loss(params, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Next-token CE + MoE aux.  ``batch``: ``tokens`` [B, S] (or
    ``embeds`` with ``labels``), optional ``loss_mask`` [B, S].  The
    logits are cast to f32 once and the CE is taken over the shifted
    labels, as the JAX package's ``lm_loss``."""
    h, aux = forward_train(params, cfg, batch)
    logits = _lm_head(params, cfg, h).float()
    labels = batch.get("labels", batch.get("tokens"))
    ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
    mask = batch.get("loss_mask")
    if mask is not None:
        m = mask[:, 1:].float()
        loss = torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)
    else:
        loss = torch.mean(ce)
    return loss + aux, {"ce": loss, "moe_aux": aux}


def prefill(params, cfg: ArchConfig, batch: dict,
            max_len: Optional[int] = None) -> tuple[torch.Tensor, Cache]:
    """Process a full prompt (``batch["tokens"]`` [B, S]); returns the
    last-position logits [B, V] and a Cache with ``max_len`` slots
    (ring-truncated to the sliding window if set).

    With a sliding window ``w`` the prompt length must satisfy
    ``s % w == 0 or s <= w`` so the ring slots stay aligned for decode.
    Explicit ``batch["positions"]`` [B, S] feed RoPE and the cache, and
    the attention mask as the JAX package's prefill uses them
    (:func:`repro_torch.models.layers.prefill_mask_positions`, decided
    once here for every layer).
    """
    x, positions = _embed_in(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    max_len = max_len or s
    positions3 = batch.get("positions3")
    x = maybe_shard(x, _DP, "model", None)            # sequence parallel
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if cfg.sliding_window and not (s <= w or s % w == 0):
        raise ValueError(f"prefill length {s} incompatible with window {w}")

    mask_pos = None                    # default positions: the index mask
    if "attn" in cfg.pattern and batch.get("positions") is not None:
        mask_pos = L.prefill_mask_positions(cfg, positions.expand(b, s),
                                            positions3)
    cache = init_cache(cfg, b, max_len, device=x.device)
    # the dry run's DTensor activations: the cache is replicated on the mesh
    cache = Cache(tuple(type(c)(*(replicate_like(t, x) for t in c))
                        for c in cache.layers), cache.index)
    h = x
    for i in range(cfg.n_blocks):
        h, new_c, _aux = _apply_block(_index(params["blocks"], i), cfg, h,
                                      positions, None, None, positions3,
                                      mask_pos)
        for pi, kind in enumerate(cfg.pattern):
            dst, src = cache.layers[pi], new_c[pi]
            if kind == "attn":
                keep = min(s, w)   # W > S: pad at the end; else last W
                dst.k[i, :, :keep] = src.k[:, s - keep:]
                dst.v[i, :, :keep] = src.v[:, s - keep:]
                dst.pos[i, :, :keep] = src.pos[:, s - keep:]
            else:
                dst.conv[i] = src.conv
                dst.ssm[i] = src.ssm
    logits = _lm_head(params, cfg, h[:, -1:])
    return logits[:, 0], Cache(layers=cache.layers, index=s)


def decode_step(params, cfg: ArchConfig, batch: dict, cache: Cache
                ) -> tuple[torch.Tensor, Cache]:
    """One-token serve step: ``batch["tokens"]`` [B, 1] (or embeds [B, 1,
    d]).  Updates ``cache``'s tensors in place; returns the logits [B, V]
    and the Cache with ``index + 1``."""
    b = batch["tokens"].shape[0] if "tokens" in batch else \
        batch["embeds"].shape[0]
    if batch.get("positions") is None:
        dev = (batch.get("tokens") if "tokens" in batch
               else batch["embeds"]).device
        batch = dict(batch, positions=torch.full(
            (b, 1), cache.index, dtype=torch.int32, device=dev))
    x, positions = _embed_in(params, cfg, batch)
    positions3 = batch.get("positions3")

    h = x
    for i in range(cfg.n_blocks):
        bc = _index(cache.layers, i)
        h, new_c, _aux = _apply_block(_index(params["blocks"], i), cfg, h,
                                      positions, bc, cache.index,
                                      positions3)
        for pi, kind in enumerate(cfg.pattern):
            if kind != "attn":    # attention wrote its slot in place
                cache.layers[pi].conv[i] = new_c[pi].conv
                cache.layers[pi].ssm[i] = new_c[pi].ssm
    logits = _lm_head(params, cfg, h)
    return logits[:, 0], Cache(layers=cache.layers, index=cache.index + 1)
