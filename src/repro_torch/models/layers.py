"""Transformer layer primitives — counterpart of ``repro/models/layers.py``.

Attention supports GQA/MQA (n_kv_heads < n_heads), explicit head_dim,
qk-RMSNorm, RoPE and M-RoPE, full-causal and sliding-window masks, and a
KV cache for prefill/decode serving.  Parameters keep the JAX layout
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ``w_gate [d, d_ff]``), so weights
carry over unchanged.

The prefill branch of :func:`attention` (``cache=None``) runs
:func:`repro_torch.kernels.ops.mha` — the ``flash_attention`` kernel on
the card — where the JAX package runs XLA, and masks as the JAX package
does (:func:`prefill_mask_positions`): by index where it takes
``chunked_sdpa`` (S ≥ 2048, S % 1024 == 0, no M-RoPE), by position
otherwise.  Positions that are ``arange(S) + c`` on every row give the
index mask either way, so the kernel then runs its index-masked path.
The decode branch and :func:`sdpa` stay plain torch (S = 1 against a
cache), as the JAX package computes them outside any kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.layout import _is_dtensor, flatten, unflatten
from repro_torch.kernels import ops
from repro_torch.nn.modules import rms_norm


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # [D/2]
    return _rotate(x, positions[..., None].float() * freqs)       # [B,S,D/2]


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: ``positions3`` [3, B, S] (temporal,
    height, width) ids; ``sections`` rotary frequency pairs per component,
    summing to head_dim // 2."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} do not sum to {d // 2}")
    freqs = rope_freqs(d, theta, x.device)
    comp = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device),
        output_size=d // 2)                                       # [D/2]
    pos = positions3.float()[comp]                                # [D/2,B,S]
    return _rotate(x, torch.movedim(pos, 0, -1) * freqs)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-attention-layer cache: keys/values [B, S_cache, KV, D]."""
    k: torch.Tensor
    v: torch.Tensor


def normal(gen: torch.Generator, shape, dtype, scale: float
           ) -> torch.Tensor:
    """``scale · N(0, 1)`` drawn from ``gen`` on its device, scaled in
    place (a full-size leaf is gigabytes: no second copy)."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(scale)


def init_attn(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
              ) -> dict:
    """Attention weights drawn from ``gen`` on its device, with optional
    leading (stacked-block) dims ``lead``."""
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    dt = cfg.pdtype
    p = {
        "wq": normal(gen, (*lead, d, h, hd), dt, 1.0 / math.sqrt(d)),
        "wk": normal(gen, (*lead, d, kv, hd), dt, 1.0 / math.sqrt(d)),
        "wv": normal(gen, (*lead, d, kv, hd), dt, 1.0 / math.sqrt(d)),
        "wo": normal(gen, (*lead, h, hd, d), dt, 1.0 / math.sqrt(h * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*lead, hd), dtype=dt, device=gen.device)
        p["k_norm"] = torch.zeros((*lead, hd), dtype=dt, device=gen.device)
    return p


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int
               ) -> torch.Tensor:
    """[.., Sq, Sk] boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """Masked scaled-dot-product attention; q [B,Sq,H,D], k/v [B,Sk,KV,D];
    the products in q's dtype, the softmax in f32, as the JAX package."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = unflatten(q, 2, (kvh, h // kvh))
    root = torch.tensor(math.sqrt(d), dtype=torch.float32).to(q.dtype)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / root.to(q.device)
    scores = scores.float()
    neg = torch.finfo(torch.float32).min
    scores = torch.where(mask[:, None, None, :, :], scores, neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return flatten(out, 2, 3)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    d, h, hd = w.shape
    return unflatten(x @ flatten(w, 1, 2), -1, (h, hd))


def out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, wo)`` as one matmul."""
    return flatten(out, -2, -1) @ flatten(wo, 0, 1)


def use_chunked_sdpa(cfg: ArchConfig, s: int, positions3) -> bool:
    """Where the JAX package's prefill and training forward take
    ``chunked_sdpa`` (``repro/models/transformer.py:212-214``): S ≥ 2048,
    S % 1024 == 0, no M-RoPE."""
    return s >= 2048 and s % 1024 == 0 and positions3 is None and \
        not cfg.mrope_sections


def prefill_mask_positions(cfg: ArchConfig, positions: torch.Tensor,
                           positions3: Optional[torch.Tensor] = None
                           ) -> Optional[torch.Tensor]:
    """The positions prefill attention masks by, as int32 ``[B, S]``, or
    None where the index mask is the JAX package's mask.

    The JAX package masks by index where it takes ``chunked_sdpa`` (S ≥
    2048, S % 1024 == 0, no M-RoPE: ``repro/models/transformer.py:212``)
    and by position otherwise (``repro/models/layers.py:152``).  Rows that
    are all ``arange(S) + c_b`` give the index mask too; that is found
    with one device comparison and one sync, so the caller decides once
    per prefill, not once per layer.  Positions that cannot be read on
    the host (a ``DTensor`` on a mesh, a ``meta`` tensor) take the
    position mask, as the JAX package does."""
    s = positions.shape[-1]
    if use_chunked_sdpa(cfg, s, positions3):
        return None
    pos = positions.to(torch.int32)
    if _is_dtensor(pos) or pos.is_meta:
        return pos.contiguous()
    steps = torch.arange(s, dtype=torch.int32, device=pos.device)
    if bool(((pos - pos[..., :1]) == steps).all()):
        return None
    return pos.contiguous()


#: :func:`attention`'s default: decide the prefill mask in the call
_DECIDE = object()


def attn_qkv(params: dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor,
             positions3: Optional[torch.Tensor] = None):
    """q [B,S,H,D], k/v [B,S,KV,D]: projections, optional qk-RMSNorm and
    rotary (M-RoPE when the config has sections) — the shared front of
    :func:`attention` and of the transformer's decode step (the JAX
    package's ``transformer._attn_qkv``)."""
    q = project(x, params["wq"])
    k = project(x, params["wk"])
    v = project(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.mrope_sections:
        p3 = positions3 if positions3 is not None else \
            positions[None].expand(3, *positions.shape)
        q = apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, p3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(params: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, cache: Optional[KVCache] = None,
              cache_index: Optional[int] = None,
              positions3: Optional[torch.Tensor] = None,
              mask_positions=_DECIDE) -> tuple[torch.Tensor, KVCache]:
    """Full attention sublayer (projections + rope + attention + output).

    Prefill: ``cache=None`` -> causal over the sequence through
    :func:`ops.mha`, masked by ``mask_positions`` (int32 ``[B, S]``, or
    None for the index mask; by default :func:`prefill_mask_positions`
    decides here), returns the fresh KVCache.  Decode: ``cache`` holds
    S_cache slots, ``cache_index`` is the write position; x has S=1; the
    returned cache is a new one.
    """
    b, s, _ = x.shape
    q, k, v = attn_qkv(params, cfg, x, positions, positions3)
    if cache is None:
        if mask_positions is _DECIDE:
            mask_positions = prefill_mask_positions(
                cfg, positions.expand(b, s), positions3)
        out = ops.mha(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True,
                      window=cfg.sliding_window, q_pos=mask_positions,
                      k_pos=mask_positions).transpose(1, 2)
        new_cache = KVCache(k, v)
    else:
        k_cache = cache.k.clone()
        v_cache = cache.v.clone()
        k_cache[:, cache_index:cache_index + s] = k.to(k_cache.dtype)
        v_cache[:, cache_index:cache_index + s] = v.to(v_cache.dtype)
        s_cache = k_cache.shape[1]
        k_pos = torch.arange(s_cache, dtype=torch.int32,
                             device=x.device)[None, :]
        valid = k_pos <= cache_index
        mask = _attn_mask(positions, k_pos.expand(b, s_cache),
                          cfg.sliding_window) & valid[:, None, :]
        out = sdpa(q, k_cache, v_cache, mask)
        new_cache = KVCache(k_cache, v_cache)

    return out_project(out, params["wo"]).to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype,
             lead: tuple = ()) -> dict:
    return {
        "w_gate": normal(gen, (*lead, d, d_ff), dtype, 1.0 / math.sqrt(d)),
        "w_up": normal(gen, (*lead, d, d_ff), dtype, 1.0 / math.sqrt(d)),
        "w_down": normal(gen, (*lead, d_ff, d), dtype,
                         1.0 / math.sqrt(d_ff)),
    }


def mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    gate = x @ params["w_gate"]
    act = F.gelu(gate, approximate="tanh") if kind == "geglu" \
        else F.silu(gate)
    return (act * (x @ params["w_up"])) @ params["w_down"]
