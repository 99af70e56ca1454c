"""Mamba2 / SSD (state-space duality) layer [arXiv:2405.21060] —
counterpart of ``repro/models/mamba2.py``.

The chunked SSD scan splits the sequence into chunks of ``Q`` tokens: the
intra-chunk terms (the quadratic, attention-like form and each chunk's
state contribution) run in :func:`repro_torch.kernels.ops.ssd_chunk` —
the ``ssd_chunk`` kernel on the card, fed the un-expanded B and C — while
the inter-chunk recurrence over the tiny ``[H, P, N]`` state stays a
plain torch loop over the chunks: the split that the Pallas kernel's
docstring describes.  The training forward (``train=True``) computes the
intra-chunk terms as the JAX package's ``ssd_chunked`` does, in einsums
that autograd differentiates (the kernel has no backward).  Decode keeps
``(conv_state, ssm_state)`` and costs O(1) per token, in plain torch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.nn.modules import rms_norm


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, di + 2*G*N]
    ssm: torch.Tensor    # [B, H, P, N] f32


def init_mamba(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()
               ) -> dict:
    """Mamba2 weights drawn from ``gen`` on its device, with optional
    leading (stacked-block) dims ``lead``."""
    mc = cfg.mamba
    d, dt_ = cfg.d_model, cfg.pdtype
    dev = gen.device
    di = mc.d_inner(d)
    h = mc.n_heads(d)
    conv_dim = di + 2 * mc.n_groups * mc.d_state
    u = torch.rand((*lead, h), generator=gen, device=dev)
    lo, hi = math.log(0.001), math.log(0.1)
    return {
        # fused input projection: [z, xBC, dt]
        "in_proj": torch.randn((*lead, d, 2 * di + 2 * mc.n_groups *
                                mc.d_state + h), generator=gen, device=dev,
                               dtype=dt_) / math.sqrt(d),
        "conv_w": torch.randn((*lead, mc.d_conv, conv_dim), generator=gen,
                              device=dev, dtype=dt_) * 0.2,
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dt_, device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=dev)).expand(*lead, h)
        .to(dt_).clone(),
        "D": torch.ones((*lead, h), dtype=dt_, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo)))
        .to(dt_),
        "norm": torch.zeros((*lead, di), dtype=dt_, device=dev),
        "out_proj": torch.randn((*lead, di, d), generator=gen, device=dev,
                                dtype=dt_) / math.sqrt(di),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    mc = cfg.mamba
    di = mc.d_inner(cfg.d_model)
    gn = mc.n_groups * mc.d_state
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * gn,
                                      zxbcdt.shape[-1] - 2 * di - 2 * gn],
                             dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: [B, T, C], w: [K, C]."""
    k, t = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + t, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it (no linear
    threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssd_intra_einsum(xc: torch.Tensor, dtc: torch.Tensor,
                      cum: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk quadratic form and each chunk's state contribution
    as the JAX package writes them (``repro/models/mamba2.py:96-117``),
    over f32 chunks: x ``[B, NC, Q, H, P]``, dt/cum ``[B, NC, Q, H]``,
    b/c ``[B, NC, Q, G, N]``.

    The JAX form exponentiates every ``cum_q - cum_s`` and then zeroes the
    non-causal ones; above the diagonal those are positive and overflow
    to inf once a chunk's decay passes e^88, and the gradient through the
    select is then inf · 0 = NaN.  Here the non-causal differences are
    masked to -inf before the exp: the same forward values, a finite
    backward."""
    q_len, rep = xc.shape[2], xc.shape[3] // bc.shape[3]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,NC,Q,Q,H]
    q_idx = torch.arange(q_len, device=xc.device)
    causal = (q_idx[:, None] >= q_idx[None, :])[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    bg = bc.repeat_interleave(rep, dim=3)                       # [B,NC,Q,H,N]
    cg = cc.repeat_interleave(rep, dim=3)
    scores = torch.einsum("bnqhk,bnshk->bnqsh", cg, bg)
    m = scores * decay * dtc[:, :, None, :, :]                  # [B,NC,Q,S,H]
    y_intra = torch.einsum("bnqsh,bnshp->bnqhp", m, xc)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # [B,NC,Q,H]
    state_contrib = torch.einsum("bnqh,bnqhk,bnqhp->bnhpk",
                                 decay_to_end * dtc, bg, xc)    # [B,NC,H,P,N]
    return y_intra, state_contrib


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                chunk: int, initial_state: torch.Tensor | None = None,
                train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: [B, T, H, P]  dt: [B, T, H]  a_log: [H]
    b, c: [B, T, G, N]  d_skip: [H]
    Returns (y [B,T,H,P], final_state [B,H,P,N] f32).  The intra-chunk
    terms run in :func:`ops.ssd_chunk` (the kernel on the card), or with
    ``train`` in the differentiable einsums of :func:`_ssd_intra_einsum`,
    recomputed in the backward.
    """
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the "
                         f"chunk {chunk}")
    nc = t // chunk
    rep = h // g

    a = -torch.exp(a_log.float())                               # [H] < 0
    dt_f = dt.float()
    dta = dt_f * a                                              # [B, T, H]

    # reshape to chunks (views: the kernel reads the strided conv output)
    xc = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt_f.reshape(bsz, nc, chunk, h)
    dtac = dta.reshape(bsz, nc, chunk, h)
    bc = b.float().reshape(bsz, nc, chunk, g, n)
    cc = c.float().reshape(bsz, nc, chunk, g, n)

    cum = torch.cumsum(dtac, dim=2)                             # [B,NC,Q,H]
    # intra-chunk quadratic form and chunk-state contributions
    if train:
        # XLA fuses the masked decay, the scores and their products into
        # the einsums and keeps none of them for the backward; autograd
        # would keep four [B, NC, Q, Q, H] f32 tensors a layer (1.6 GB at
        # 8 × 2048 on mamba2-130m), so the backward recomputes them
        y_intra, state_contrib = checkpoint(_ssd_intra_einsum, xc, dtc, cum,
                                            bc, cc, use_reentrant=False)
    else:
        y_intra, state_contrib = ops.ssd_chunk(xc, dtc, cum, bc, cc)

    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [B,NC,H]
    state = initial_state.float() if initial_state is not None else \
        torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(nc):                                         # emit PREV
        prev.append(state)
        state = state * chunk_decay[:, i, :, None, None] + \
            state_contrib[:, i]
    prev_states = torch.stack(prev, dim=1)                      # [B,NC,H,P,N]

    # inter-chunk: y_inter[t] = exp(cum_t) * C_t · state_prev
    cg = cc.repeat_interleave(rep, dim=3)                       # [B,NC,Q,H,N]
    y_inter = torch.einsum("bnqhk,bnhpk->bnqhp",
                           cg * torch.exp(cum)[..., None], prev_states)

    y = (y_intra + y_inter).reshape(bsz, t, h, p)
    y = y + d_skip.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state


def mamba_layer(params: dict, cfg: ArchConfig, x: torch.Tensor,
                cache: MambaCache | None = None, train: bool = False
                ) -> tuple[torch.Tensor, MambaCache]:
    """Full mamba2 block. Prefill: cache=None. Decode: S==1.  ``train``
    (with cache=None) runs the differentiable SSD form."""
    mc = cfg.mamba
    bsz, t, _ = x.shape
    di = mc.d_inner(cfg.d_model)
    h = mc.n_heads(cfg.d_model)
    g, n, p = mc.n_groups, mc.d_state, mc.head_dim

    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)

    if cache is None:
        xbc_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"])
        conv_state = xbc[:, -(mc.d_conv - 1):, :] if t >= mc.d_conv - 1 \
            else F.pad(xbc, (0, 0, mc.d_conv - 1 - t, 0))
        xs, bs, cs = torch.split(xbc_conv, [di, g * n, g * n], dim=-1)
        dt_act = _softplus(dt.float() + params["dt_bias"].float())
        y, final_state = ssd_chunked(
            xs.reshape(bsz, t, h, p), dt_act, params["A_log"],
            bs.reshape(bsz, t, g, n), cs.reshape(bsz, t, g, n),
            params["D"], min(mc.chunk, t), train=train)
        new_cache = MambaCache(conv_state.to(x.dtype), final_state.float())
    else:
        # O(1) decode step
        conv_in = torch.cat([cache.conv, xbc], dim=1)           # [B, K, C]
        conv_out = torch.einsum("bkc,kc->bc", conv_in,
                                params["conv_w"]) + params["conv_b"]
        xbc_conv = F.silu(conv_out)[:, None, :]
        xs, bs, cs = torch.split(xbc_conv, [di, g * n, g * n], dim=-1)
        dt_act = _softplus(dt.float() + params["dt_bias"].float())
        da = torch.exp(dt_act[:, 0, :] *
                       -torch.exp(params["A_log"].float()))     # [B,H]
        xh = xs.reshape(bsz, h, p).float()
        bh = bs.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)
        ch = cs.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)
        dtx = dt_act[:, 0, :, None] * xh                        # [B,H,P]
        new_ssm = cache.ssm * da[:, :, None, None] + \
            torch.einsum("bhp,bhk->bhpk", dtx, bh.float())
        yh = torch.einsum("bhpk,bhk->bhp", new_ssm, ch.float())
        yh = yh + params["D"].float()[None, :, None] * xh
        y = yh.reshape(bsz, 1, h, p).to(x.dtype)
        new_cache = MambaCache(conv_in[:, 1:, :].to(cache.conv.dtype),
                               new_ssm)

    # gated RMSNorm + output projection
    y = y.reshape(bsz, t, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return (y @ params["out_proj"]).to(x.dtype), new_cache


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device="cuda",
                     lead: tuple = ()) -> MambaCache:
    mc = cfg.mamba
    di = mc.d_inner(cfg.d_model)
    h = mc.n_heads(cfg.d_model)
    conv_dim = di + 2 * mc.n_groups * mc.d_state
    return MambaCache(
        conv=torch.zeros((*lead, batch, mc.d_conv - 1, conv_dim),
                         dtype=dtype, device=device),
        ssm=torch.zeros((*lead, batch, h, mc.head_dim, mc.d_state),
                        dtype=torch.float32, device=device))
