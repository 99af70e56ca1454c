"""Public wire and aggregation ops, dispatched by the tensor's device.

Counterpart of ``repro/kernels/ops.py``.  Each op that has a kernel runs
it on a CUDA tensor and its plain PyTorch version on a CPU tensor; any
other device raises.  There is no fallback from the kernel to the plain
version and no global backend switch — the tensor decides.

* :func:`wire_pack` / :func:`wire_unpack` — lane-block gather/scatter
  (``varco_pack`` / ``varco_unpack`` kernels), differentiable: each is the
  other's VJP under the same ``(kept, inv)`` pair;
* :func:`ell_aggregate` — the ELL aggregation of the local edges and, on
  the p2p wire, of the remote ones (``ell_spmm`` kernel); its
  x-cotangent is the same kernel over the reversed lists;
* :func:`pack_quant` / :func:`unpack_quant` — the fused quantised-wire
  codecs (``varco_pack_quant`` / ``varco_unpack_quant`` kernels; with
  ``keys``, stochastic rounding in the ``varco_pack_quant_stochastic``
  instantiation), and :func:`quant_hop`, the straight-through sub-byte
  hop built from them;
* :func:`random_mask` — the paper's shared-key Bernoulli element mask of
  the dense compressing wire (``random_mask`` kernel), differentiable: its
  backward is the same kernel on the cotangent (the mask depends only on
  the key and the index, so nothing is saved);
* :func:`compress_pack` / :func:`compress_unpack` /
  :func:`compress_roundtrip` (with :func:`compression_indices`) and
  :func:`aggregate` — the same kernels forward only, on one ``[N, F]``
  block: the JAX package's kernel-correctness surface;
* :func:`mha` — flash attention of the LM prefill (``flash_attention``
  kernel; index or position masks), and :func:`ssd_chunk` — the Mamba2
  intra-chunk form (``ssd_chunk`` kernel); forward only, as in the JAX
  package;
* the elementwise quantised-wire codecs (:func:`quant_levels`,
  :func:`pack_bits`, :func:`dequant_bits`, :func:`quant_dequant`,
  :func:`wire_quant`) — PyTorch on every device, as the JAX runtime
  composes them from jnp ops; their ``key=`` (stochastic rounding)
  draws its uniforms with the ``random_uniform`` kernel,
  :func:`round_key` is the JAX package's per-pair rounding key
  schedule and :func:`default_wire_rounding` the mode a step picks when
  its caller names none.

Every op takes a leading batch dimension (``[Q, N, F]`` with per-batch
index rows) or, for the wire ops, an unbatched ``[N, F]`` with one index
vector.  Each differentiable op is a ``torch.autograd.Function`` whose
backward launches kernels too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import prng

from . import ref
from .ell_spmm import ell_spmm, ell_spmm_plain
from .flash_attention import flash_attention, flash_attention_plain
from .randmask import keys_tensor
from .randmask import random_mask as random_mask_kernel
from .randmask import random_mask_plain, random_uniform, random_uniform_plain
from .ssd_chunk import ssd_chunk as ssd_chunk_kernel
from .ssd_chunk import ssd_chunk_plain
from .varco_pack import (LANE, block_mask_indices, varco_pack,
                         varco_pack_plain, varco_pack_quant,
                         varco_pack_quant_plain,
                         varco_pack_quant_stochastic,
                         varco_pack_quant_stochastic_plain, varco_unpack,
                         varco_unpack_plain, varco_unpack_quant,
                         varco_unpack_quant_plain)

#: wire bit-widths the quantised codecs speak — 32 is the fp32 passthrough,
#: the rest symmetric per-lane-block int formats bit-packed to sub-byte
#: storage (8/w lanes per byte)
WIRE_WIDTHS = (2, 4, 8, 32)


def _route(kernel, plain, *args):
    dev = args[0].device
    if dev.type == "cuda":
        return kernel(*args)
    if dev.type in ("cpu", "meta"):     # meta: shapes only (the dry run)
        return plain(*args)
    raise ValueError(f"no kernel or plain version for device {dev}")


def _pack(x, kept):
    return _route(varco_pack, varco_pack_plain, x.contiguous(), kept)


def _unpack(packed, inv):
    return _route(varco_unpack, varco_unpack_plain, packed.contiguous(), inv)


class _WirePack(torch.autograd.Function):
    """``varco_pack`` forward, ``varco_unpack`` backward."""

    @staticmethod
    def forward(ctx, x, kept, inv):
        ctx.save_for_backward(inv)
        return _pack(x, kept)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        _need_index(inv, "wire_pack", "inv")
        return _unpack(g, inv), None, None


class _WireUnpack(torch.autograd.Function):
    """``varco_unpack`` forward, ``varco_pack`` backward."""

    @staticmethod
    def forward(ctx, packed, inv, kept):
        ctx.save_for_backward(kept)
        return _unpack(packed, inv)

    @staticmethod
    def backward(ctx, g):
        kept, = ctx.saved_tensors
        _need_index(kept, "wire_unpack", "kept")
        return _pack(g, kept), None, None


def _no_index(like: torch.Tensor) -> torch.Tensor:
    """The placeholder of an index a forward-only call leaves out."""
    return torch.empty((0,), dtype=torch.int32, device=like.device)


def _need_index(idx: torch.Tensor, op: str, name: str) -> None:
    if idx.numel() == 0:
        raise ValueError(f"{op}'s backward needs {name}: pass it to make "
                         f"the op differentiable")


def _batched(fn, x, *idx):
    if x.dim() == 2:
        return fn(x[None], *(None if i is None else i[None] for i in idx))[0]
    return fn(x, *idx)


def _index_on(idx, like: torch.Tensor) -> torch.Tensor:
    """An index (numpy or tensor) as int32 on ``like``'s device."""
    return torch.as_tensor(idx, dtype=torch.int32, device=like.device)


def wire_pack(x: torch.Tensor, kept: torch.Tensor,
              inv: torch.Tensor | None = None) -> torch.Tensor:
    """Gather kept lane-blocks: ``[Q, N, F] -> [Q, N, K·128]`` with
    ``kept [Q, K]`` (or ``[N, F]`` with ``kept [K]``).  ``inv``, the
    matched scatter map, serves the backward; without it the op is
    forward-only."""
    return _batched(lambda a, k, i: _WirePack.apply(
        a, k, _no_index(a) if i is None else i), x, kept, inv)


def wire_unpack(packed: torch.Tensor, inv: torch.Tensor,
                kept: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter a wire payload back: ``[Q, M, K·128] -> [Q, M, F]`` with
    ``inv [Q, F/128]``, zero-filling dropped blocks (``inv < 0``).
    ``kept`` serves the backward; without it the op is forward-only."""
    return _batched(lambda a, i, k: _WireUnpack.apply(
        a, i, _no_index(a) if k is None else k), packed, inv, kept)


def compress_pack(x: torch.Tensor, block_idx) -> torch.Tensor:
    """Gather the kept lane-blocks: ``x [N, F]``, ``block_idx [K]`` ->
    ``[N, K·128]`` (the ``varco_pack`` kernel on a CUDA tensor), forward
    only; :func:`wire_pack` is the differentiable op."""
    return _batched(_pack, x, _index_on(block_idx, x))


def compress_unpack(packed: torch.Tensor, inv_idx) -> torch.Tensor:
    """Scatter the kept blocks back, zeros elsewhere: ``packed [N,
    K·128]``, ``inv_idx [F/128]`` -> ``[N, F]`` (``varco_unpack``),
    forward only."""
    return _batched(_unpack, packed, _index_on(inv_idx, packed))


def compression_indices(key, n_blocks: int, rate: float
                        ) -> tuple[np.ndarray, np.ndarray]:
    """``(kept, inv)`` of the shared-key block mask at ``rate``
    (:func:`~repro_torch.kernels.varco_pack.block_mask_indices`)."""
    return block_mask_indices(key, n_blocks, rate)


def compress_roundtrip(key, x: torch.Tensor, rate: float
                       ) -> tuple[torch.Tensor, int]:
    """VARCO's compress -> wire -> decompress round trip through the
    kernels: ``(x with the dropped blocks zeroed, bits of the packed
    payload)``."""
    kept, inv = block_mask_indices(key, x.shape[-1] // LANE, rate)
    packed = compress_pack(x, kept)
    wire_bits = packed.numel() * torch.finfo(packed.dtype).bits
    return compress_unpack(packed, inv), wire_bits


def aggregate(x: torch.Tensor, nbr, w: torch.Tensor) -> torch.Tensor:
    """Forward-only ELL aggregation ``out[i] = Σ_k w[i, k] x[nbr[i, k]]``:
    ``x [N_src, F]``, ``nbr``/``w [N_dst, K]`` -> ``[N_dst, F]`` (the
    ``ell_spmm`` kernel on a CUDA tensor); :func:`ell_aggregate` is the
    differentiable op."""
    return _batched(lambda a, n, ww: _route(ell_spmm, ell_spmm_plain,
                                            a.contiguous(), n, ww),
                    x, _index_on(nbr, x), w)


class _EllAggregate(torch.autograd.Function):
    """``ell_spmm`` forward; ``ell_spmm`` over the reversed lists for the
    x-cotangent, K-sliced plain PyTorch for the weight cotangent (the JAX
    package computes it outside any kernel too).  ``x`` is kept for the
    backward only where the weights need their cotangent."""

    @staticmethod
    def forward(ctx, x, nbr, w, rnbr, rslot):
        ctx.save_for_backward(x if ctx.needs_input_grad[2] else None, nbr, w,
                              rnbr, rslot)
        return _route(ell_spmm, ell_spmm_plain, x.contiguous(), nbr, w)

    @staticmethod
    def backward(ctx, g):
        x, nbr, w, rnbr, rslot = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            _need_index(rnbr, "ell_aggregate", "the reversed lists "
                        "(rnbr, rslot)")
            q = w.shape[0]
            # rw[q, s, r] = w[q].flat[rslot[q, s, r]]: the gather is per
            # partition, so the flat slot needs no q·P·K offset
            rw = torch.gather(w.reshape(q, -1), 1,
                              rslot.reshape(q, -1).clamp(min=0).long())
            rw = torch.where(rslot >= 0, rw.reshape(rslot.shape),
                             torch.zeros((), dtype=w.dtype, device=w.device))
            dx = _route(ell_spmm, ell_spmm_plain, g, rnbr, rw.contiguous())
        if ctx.needs_input_grad[2]:
            q, n_src, f = x.shape
            off = (torch.arange(q, device=x.device) * n_src)[:, None]
            xf = x.reshape(q * n_src, f).float()
            dw = torch.zeros(nbr.shape, dtype=torch.float32, device=x.device)
            for kk in range(nbr.shape[-1]):
                rows = (nbr[:, :, kk].long() + off).reshape(-1)
                dw[:, :, kk] = (g.float() * xf.index_select(0, rows)
                                .reshape(g.shape)).sum(-1)
            dw = dw.to(w.dtype)
        return dx, None, dw, None, None


def ell_aggregate(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                  rnbr: torch.Tensor | None = None,
                  rslot: torch.Tensor | None = None) -> torch.Tensor:
    """ELL aggregation ``out[q, i] = Σ_k w[q, i, k] x[q, nbr[q, i, k]]``
    over every partition at once: ``x [Q, Ns, F]``, ``nbr``/``w [Q, Nd,
    K]``.  ``rnbr``/``rslot [Q, Ns, RK]`` are the reversed lists
    (``repro_torch.dist.halo.build_reverse_ell``, ``remote_ell``) the
    x-cotangent runs over; without them the op is forward-only."""
    empty = _no_index(x)
    return _EllAggregate.apply(x, nbr, w,
                               empty if rnbr is None else rnbr,
                               empty if rslot is None else rslot)


class _RandomMask(torch.autograd.Function):
    """``random_mask`` forward; the same kernel on the cotangent backward
    (``d(where(mask, x·scale, 0)) = where(mask, g·scale, 0)``)."""

    @staticmethod
    def forward(ctx, x, keys, p, scale, offset):
        ctx.save_for_backward(keys)
        ctx.args = (p, scale, offset)
        out, counts = _route(random_mask_kernel, random_mask_plain,
                             x.contiguous(), keys, p, scale, offset, True)
        ctx.mark_non_differentiable(counts)
        return out, counts

    @staticmethod
    def backward(ctx, g, _g_counts):
        keys, = ctx.saved_tensors
        dx, _ = _route(random_mask_kernel, random_mask_plain,
                       g.contiguous(), keys, *ctx.args, False)
        return dx, None, None, None, None


def random_mask(x: torch.Tensor, keys: torch.Tensor, p: float,
                scale: float = 1.0, offset: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's random element mask over workers: x ``[Q, ...]`` f32
    or bf16 (the output keeps x's dtype), keys int32 ``[Q, 2]`` (uint32 bits; ``randmask.keys_tensor``), ``p``
    and ``scale`` float32 values -> ``(where(mask, x·scale, 0), kept
    counts int64 [Q])`` with worker ``q``'s mask bitwise
    ``jax.random.bernoulli(keys[q], p, x.shape[1:])``; ``offset`` shifts
    every counter.  Differentiable in ``x``."""
    return _RandomMask.apply(x, keys, p, scale, offset)


# ---------------------------------------------------------------------------
# LM kernels
# ---------------------------------------------------------------------------


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        q_pos: torch.Tensor | None = None,
        k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Flash attention: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]`` (views
    with a contiguous last dim) -> ``[B, H, S, D]`` in q's dtype; masks
    from indices (causal, optional sliding window), or from the int32
    ``[B, S]`` positions ``q_pos``/``k_pos`` when given; GQA by ``h //
    group``, fully masked rows 0."""
    return _route(flash_attention, flash_attention_plain, q, k, v, causal,
                  window, q_pos, k_pos)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD intra-chunk form: x ``[B, NC, Q, H, P]``, dt/cum ``[B,
    NC, Q, H]``, b/c un-expanded ``[B, NC, Q, G, N]`` -> (y_intra ``[B, NC,
    Q, H, P]``, state_contrib ``[B, NC, H, P, N]``), f32."""
    return _route(ssd_chunk_kernel, ssd_chunk_plain, x, dt, cum, b, c)


# ---------------------------------------------------------------------------
# Fused quantised-wire codecs
# ---------------------------------------------------------------------------


def qmax_of(width) -> torch.Tensor:
    """``2^(w-1) - 1`` in float32 (127, 7, 1 at widths 8, 4, 2)."""
    w = torch.as_tensor(width, dtype=torch.float32)
    return 2.0 ** (w - 1.0) - 1.0


def _keys_on(keys, device) -> torch.Tensor:
    """Rounding keys as the int32 ``[B, 2]`` tensor the kernels read:
    ``keys`` is such a tensor or numpy ``uint32 [..., 2]`` keys
    (``repro_torch.prng``), flattened over their leading dimensions."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int32).reshape(-1, 2) \
            .contiguous()
    return keys_tensor(keys, device)


def _pack_quant(x, kept, qmax, width, keys):
    if keys is None:
        return _route(varco_pack_quant, varco_pack_quant_plain, x, kept,
                      qmax, width)
    return _route(varco_pack_quant_stochastic,
                  varco_pack_quant_stochastic_plain, x, kept, qmax,
                  _keys_on(keys, x.device), width)


def pack_quant(x: torch.Tensor, kept: torch.Tensor, width: int,
               qmax: torch.Tensor | None = None, keys=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused gather + quantise + bit-pack: ``[B, N, F]`` with ``kept [B,
    K]`` -> ``(payload uint8 [B, N, K·128·width/8], scales f32 [B, N,
    K])`` (or unbatched ``[N, F]`` with ``kept [K]``).  ``qmax [B]``
    defaults to ``2^(width-1) - 1`` for every row — the JAX package's
    static-width ``pack_quant``; a smaller per-row ``qmax`` quantises that
    row at a narrower width inside the same storage.  ``keys`` (one
    uint32 key per batch row, ``[B, 2]``; one ``[2]`` key unbatched)
    rounds stochastically: bitwise ``pack_bits(quant_levels(wire_pack(x),
    width, key=keys[b]))``; without them rounding is half to even."""
    squeeze = x.dim() == 2
    if squeeze:
        x, kept = x[None], kept[None]
    if qmax is None:
        qmax = qmax_of(width).expand(x.shape[0])
    qmax = qmax.to(device=x.device, dtype=torch.float32).contiguous()
    payload, scales = _pack_quant(x.contiguous(), kept, qmax, width, keys)
    return (payload[0], scales[0]) if squeeze else (payload, scales)


def unpack_quant(payload: torch.Tensor, scales: torch.Tensor,
                 inv: torch.Tensor, width: int) -> torch.Tensor:
    """Fused bit-unpack + dequantise + scatter: ``(payload uint8 [B, N,
    K·128·width/8], scales [B, N, K], inv [B, F/128]) -> f32 [B, N, F]``
    with dropped blocks zero-filled (or unbatched)."""
    if payload.dim() == 2:
        return unpack_quant(payload[None], scales[None], inv[None],
                            width)[0]
    return _route(varco_unpack_quant, varco_unpack_quant_plain,
                  payload.contiguous(), scales.contiguous(), inv, width)


class _QuantHop(torch.autograd.Function):
    """The sub-byte hop: ``unpack_quant(pack_quant(x))`` forward, the
    straight-through estimator followed by ``wire_unpack``'s VJP
    backward — the cotangent passes unchanged on kept blocks and is zero
    on dropped ones.  ``wire_out`` (a list, or None) receives the
    ``(payload, scales)`` that crossed the wire."""

    @staticmethod
    def forward(ctx, x, kept, inv, qmax, width, keys, wire_out):
        payload, scales = _pack_quant(x, kept, qmax, width, keys)
        if wire_out is not None:
            wire_out.append((payload, scales))
        ctx.save_for_backward(inv)
        return _route(varco_unpack_quant, varco_unpack_quant_plain,
                      payload, scales, inv, width)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        keep = (inv >= 0).to(g.dtype).repeat_interleave(LANE, dim=-1)
        return g * keep[:, None, :], None, None, None, None, None, None


def quant_hop(x: torch.Tensor, kept: torch.Tensor, inv: torch.Tensor,
              qmax: torch.Tensor, width: int, keys=None,
              wire_out: list | None = None) -> torch.Tensor:
    """What a receiver rebuilds from a sub-byte hop: ``x [B, H, F]`` (the
    full-width pre-quantisation rows), each batch row's ``kept [B, K]`` /
    ``inv [B, F/128]`` and ``qmax [B]``, stored at ``width`` bits ->
    ``[B, H, F]`` f32, bitwise ``wire_unpack(dequant_bits(pack_bits(
    quant_levels(wire_pack(x)))))``; ``keys [B, 2]`` rounds each row
    stochastically under its key.  Gradients pass straight through to
    ``x`` on the kept blocks.  ``wire_out``, a list, captures the
    ``(payload, scales)`` the hop shipped."""
    return _QuantHop.apply(x.contiguous(), kept, inv,
                           qmax.to(device=x.device,
                                   dtype=torch.float32).contiguous(), width,
                           keys, wire_out)


# ---------------------------------------------------------------------------
# Quantised wire codecs
# ---------------------------------------------------------------------------


def _width_tensor(width, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(width, dtype=torch.float32, device=like.device)


#: fold_in salt separating the stochastic-rounding key stream from the
#: mask-selection streams that share the per-exchange key
ROUND_SALT = 0x5EED


def default_wire_rounding(device) -> str:
    """Rounding mode of the quantised wire when a caller names none
    (``make_auto_train_step(rounding=None)``): ``"stochastic"`` on a CUDA
    device, the port's hardware target, where the convergence argument
    wants an unbiased codec (the JAX package's default on its own
    hardware target); ``"rint"`` on the CPU, the deterministic
    round-half-to-even that CPU parity with the JAX package is held
    under."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "stochastic"
    if kind == "cpu":
        return "rint"
    raise ValueError(f"no wire rounding default for device {device}")


def round_key(key, sender: int, hop: int | None = None) -> np.ndarray:
    """The JAX package's per-pair stochastic-rounding key: the
    per-exchange key (``fold_in(step key, call)``) salted away from the
    mask streams, folded with the sender and — on the p2p wire — the ring
    hop (``uint32[2]``, ``repro_torch.prng``)."""
    k = prng.fold_in(prng.fold_in(np.asarray(key, np.uint32), ROUND_SALT),
                     sender)
    return k if hop is None else prng.fold_in(k, hop)


def _uniforms(key, xb: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` for each key of ``key`` (numpy
    ``uint32 [..., 2]`` or an int32 tensor), whose leading dimensions
    prefix ``xb``'s: each key draws over the trailing shape, counters in
    row-major order.  One ``random_uniform`` launch on the card."""
    lead = (np.shape(key) if not isinstance(key, torch.Tensor)
            else tuple(key.shape))[:-1]
    if tuple(xb.shape[:len(lead)]) != tuple(lead):
        raise ValueError(f"keys {tuple(lead)} do not prefix the shape "
                         f"{tuple(xb.shape)}")
    keys = _keys_on(key, xb.device)
    n = math.prod(xb.shape[len(lead):])
    return _route(random_uniform, random_uniform_plain, keys, n) \
        .reshape(xb.shape)


def quant_levels(x: torch.Tensor, width, key=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lane-block symmetric quantisation: ``x [..., nb·128]`` ->
    ``(int8 levels [..., nb·128], f32 scales [..., nb])`` with ``qmax =
    2^(w-1) - 1`` and ``scale = amax/qmax`` (1 for an all-zero block).
    Round half to even by default; ``key`` (one ``uint32[2]`` key, or
    keys ``[..., 2]`` whose leading dimensions prefix ``x``'s) rounds
    stochastically, ``floor(v + u)`` with ``u = uniform(key, [...,
    nb, 128])`` — the JAX package's ``key=``.  ``width`` is a number or a
    tensor broadcastable against the scales; ``width >= 32`` yields
    levels that callers on the fp32 passthrough discard."""
    lead = x.shape[:-1]
    nb = x.shape[-1] // LANE
    xb = x.reshape(*lead, nb, LANE)
    w = _width_tensor(width, x)
    qmax = 2.0 ** (w - 1.0) - 1.0
    amax = xb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    v = xb / scale[..., None]
    qv = torch.round(v) if key is None else torch.floor(v + _uniforms(key,
                                                                      xb))
    qm = torch.broadcast_to(qmax, scale.shape)[..., None]
    qv = torch.minimum(torch.maximum(qv, -qm), qm)
    return qv.to(torch.int8).reshape(x.shape), scale


def quant_dequant(x: torch.Tensor, width, key=None) -> torch.Tensor:
    """Symmetric per-lane-block quantise→dequantise at ``width`` bits;
    ``width >= 32`` is an exact fp32 passthrough; ``key`` as in
    :func:`quant_levels`."""
    lead = x.shape[:-1]
    nb = x.shape[-1] // LANE
    xb = x.reshape(*lead, nb, LANE)
    w = _width_tensor(width, x)
    levels, scale = quant_levels(x, width, key)
    dq = levels.to(torch.float32).reshape(*lead, nb, LANE) * scale[..., None]
    exact = torch.broadcast_to(w >= 32.0, scale.shape)[..., None]
    return torch.where(exact, xb, dq).reshape(x.shape)


def wire_quant(x: torch.Tensor, width, key=None) -> torch.Tensor:
    """Straight-through :func:`quant_dequant`: the forward sees the
    quantised wire values, ``x + (quant_dequant(x) - x)`` term for term as
    the JAX package rounds them; the backward passes gradients through
    unchanged.  ``key`` as in :func:`quant_levels`."""
    return x + (quant_dequant(x, width, key) - x).detach()


def pack_bits(levels: torch.Tensor, width: int) -> torch.Tensor:
    """Bit-pack int-``width`` levels to bytes (``8/width`` lanes per byte,
    little-endian; ``width == 8`` is the identity reinterpret)."""
    return ref.pack_bits_reference(levels, width)


def unpack_bits(packed: torch.Tensor, width: int, m: int | None = None
                ) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: sign-extend each ``width``-bit field
    back to int8 levels (``m`` trims the tail byte's zero-pad lanes)."""
    return ref.unpack_bits_reference(packed, width, m)


def dequant_bits(payload: torch.Tensor, scales: torch.Tensor, width: int
                 ) -> torch.Tensor:
    """Value-level decode of a sub-byte wire buffer: payload uint8
    ``[..., K·128·width/8]`` × scales f32 ``[..., K]`` -> f32
    ``[..., K·128]`` (``levels · scale``)."""
    k = scales.shape[-1]
    levels = ref.unpack_bits_reference(payload, width, k * LANE)
    lb = levels.to(torch.float32).reshape(*scales.shape, LANE)
    return (lb * scales[..., None]).reshape(*payload.shape[:-1], k * LANE)


def per_block_wire_bits(width) -> torch.Tensor:
    """On-wire bits of ONE kept lane-block per row at ``width``: the
    ``128·width`` payload plus one fp32 scale, or exactly ``128·32`` on
    the fp32 wire (no scale ships)."""
    w = torch.as_tensor(width, dtype=torch.float32)
    return torch.where(w >= 32.0, torch.tensor(LANE * 32.0),
                       LANE * w + 32.0)
