"""Plain PyTorch counterparts of the JAX package's kernel oracles
(``repro/kernels/ref.py``), unbatched like those: ``[N, F]`` rows with one
index vector.  The batched plain versions the kernels are checked against
live beside each kernel (``varco_pack_plain``, ``varco_pack_quant_plain``,
``ell_spmm_plain``, ``flash_attention_plain``, ``ssd_chunk_plain``)."""

from __future__ import annotations

import torch

from .ell_spmm import ell_spmm_plain
from .flash_attention import attention_mask
from .varco_pack import (LANE, pack_bits_plain, unpack_bits_plain,
                         varco_pack_plain, varco_unpack_plain)

#: bit-pack int-``width`` levels (8/width lanes per byte, little-endian)
pack_bits_reference = pack_bits_plain
#: sign-extending inverse of :func:`pack_bits_reference`
unpack_bits_reference = unpack_bits_plain


def pack_reference(x: torch.Tensor, block_idx: torch.Tensor) -> torch.Tensor:
    """Gather kept lane-blocks. x [N, F] -> [N, K*LANE]."""
    return varco_pack_plain(x[None], block_idx[None])[0]


def unpack_reference(packed: torch.Tensor, inv_idx: torch.Tensor
                     ) -> torch.Tensor:
    """Scatter kept blocks; zero dropped. packed [N, K*LANE] -> [N, F]."""
    return varco_unpack_plain(packed[None], inv_idx[None])[0]


def ell_spmm_reference(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor
                       ) -> torch.Tensor:
    """out[i] = sum_k w[i,k] x[nbr[i,k]] (k ascending, f32)."""
    return ell_spmm_plain(x[None], nbr[None], w[None])[0]


def quant_levels_reference(packed: torch.Tensor, width: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, block) symmetric quantisation of a packed fp32 payload:
    [N, K*LANE] -> (int8 levels [N, K*LANE], scales f32 [N, K]);
    ``qmax = 2^(width-1) - 1``, zero blocks get scale 1."""
    n, kf = packed.shape
    k = kf // LANE
    qmax = float(2 ** (width - 1) - 1)
    pb = packed.reshape(n, k, LANE)
    amax = pb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(pb / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8).reshape(n, kf), scale


def pack_quant_reference(x: torch.Tensor, block_idx: torch.Tensor,
                         width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused pack+quantise oracle: x [N, F], block_idx [K] -> (payload
    uint8 [N, K*LANE*width/8], scales f32 [N, K]) — exactly
    ``pack_bits(quant_levels(pack(x)))``."""
    levels, scale = quant_levels_reference(pack_reference(x, block_idx),
                                           width)
    return pack_bits_reference(levels, width), scale


def quant_dequant_reference(levels: torch.Tensor, scales: torch.Tensor
                            ) -> torch.Tensor:
    """Decode *unpacked* quantisation levels: int8 [N, K*LANE] × scales
    [N, K] -> f32 [N, K*LANE]."""
    n, kf = levels.shape
    k = kf // LANE
    pb = levels.to(torch.float32).reshape(n, k, LANE)
    return (pb * scales[..., None]).reshape(n, kf)


def unpack_quant_reference(payload: torch.Tensor, scales: torch.Tensor,
                           width: int) -> torch.Tensor:
    """Receiver's side of :func:`pack_quant_reference`: sub-byte payload
    uint8 [N, K*LANE*width/8] × scales [N, K] -> f32 [N, K*LANE]."""
    k = scales.shape[-1]
    levels = unpack_bits_reference(payload, width, k * LANE)
    return quant_dequant_reference(levels, scales)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_pos: torch.Tensor | None = None,
                  k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B,H,S,D]; k/v: [B,KV,S,D]. Dense masked softmax attention in
    f32 (k/v repeated to the query heads), masked by index or by the
    ``[B, S]`` positions; fully masked rows give 0."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / \
        (d ** 0.5)
    mask = attention_mask(s, causal, window, q.device, q_pos, k_pos)
    if mask.dim() == 3:
        mask = mask[:, None]
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", probs,
                        v.float()).to(q.dtype)


def ssd_reference(x, dt, a_log, b, c, d_skip):
    """Sequential (non-chunked) SSD recurrence — oracle for ssd_chunked.

    x: [B,T,H,P]  dt: [B,T,H]  a_log: [H]  b,c: [B,T,G,N]  d_skip: [H]
    """
    bsz, t, h, p = x.shape
    n = b.shape[3]
    rep = h // b.shape[2]
    a = -torch.exp(a_log.float())
    bg = b.repeat_interleave(rep, dim=2).float()
    cg = c.repeat_interleave(rep, dim=2).float()
    xf = x.float()
    dtf = dt.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        da = torch.exp(dtf[:, i] * a)                         # [B,H]
        state = state * da[..., None, None] + torch.einsum(
            "bhp,bhk->bhpk", dtf[:, i, :, None] * xf[:, i], bg[:, i])
        ys.append(torch.einsum("bhpk,bhk->bhp", state, cg[:, i]))
    y = torch.stack(ys, dim=1)                                # [B,T,H,P]
    y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype)
