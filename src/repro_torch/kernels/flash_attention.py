"""Flash attention — causal / sliding-window, GQA — on Hopper.

``out[b, h, i] = Σ_j softmax_j(q_i · k_j / √D) v_j`` over the keys ``j``
that the mask keeps (``j ≤ i`` when causal, ``j > i − window`` when a
window is set), with query head ``h`` reading KV head ``h // group``.
Rows whose every key is masked give 0, as ``ref.mha_reference`` does.
With explicit positions ``q_pos``/``k_pos`` (int32 ``[B, S]``) the mask
compares positions instead of indices (``k_pos[j] ≤ q_pos[i]``,
``k_pos[j] > q_pos[i] − window``), as the JAX package's prefill masks by
position (``repro/models/layers.py:152``).  Prefill passes the same
positions for both, so key ``i`` always has query ``i``'s position and
no row is ever fully masked: the port's 0 for such a row and the JAX
package's ``finfo.min`` fill cannot disagree there.

Two CUDA kernels replace ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``, the ``pl.pallas_call`` at
``flash_attention.py:108``); :func:`flash_attention` picks one by the
explicit rule :func:`kernel_for` on ``(dtype, D)``:

* :func:`flash_attention_wgmma` (``csrc/flash_attention_wgmma.cu``) for
  bf16 at ``D ∈ {64, 128, 256}`` — every head dim of the repo's full-size
  configs.  Bound by operations (granite's prefill: 1.4e11 bf16 flops
  against 84 MB), so it runs both products on the tensor cores: TMA loads
  Q once and K/V tiles through a ring of mbarrier-paced stages, ``S =
  Q·Kᵀ`` by ``wgmma`` from shared memory, the online softmax on the f32
  accumulator fragment in registers, P rounded to bf16 straight into
  wgmma's register A operand for ``O += P·V``.  Rounding P to bf16 is its
  one rounding beyond the plain version's (about one bf16 ulp of the
  output, which is bf16 anyway).
* :func:`flash_attention_simt` (``csrc/flash_attention.cu``) for f32 and
  for bf16 at ``D ∈ {16, 32}`` (the smoke configs' widths): the first,
  CUDA-core design — 64×64 tiles as f32 in shared memory, FMA products,
  the online softmax in registers.

Both compute the same function: f32 ``m``/``l``/accumulators, key tiles
wholly outside the causal or window band skipped, keys past ``S`` masked
(any length runs; the Pallas kernel asserts ``S % 128 == 0``), masks from
indices as in the Pallas kernel and ``chunked_sdpa``.  Under positions
the mask need not be lower-triangular in index (left padding repeats a
position), so index-based tile skipping would be wrong: the wrapper
computes, per query tile, the key range outside which the tiles' position
extremes prove every key masked, and the run of tiles inside it that
they prove wholly unmasked (:func:`position_key_ranges`); the kernel
walks the range and masks by position the tiles outside that run.  This is a
dispatch, not a fallback: a failed build or launch of either raises.

Layout: the public function keeps the JAX layout ``[B, H, S, D]``, but
takes strided views — the model passes ``[B, S, H, D]`` tensors through
``transpose(1, 2)`` and both kernels read them in place through their
strides (no transpose copy); the output has ``q``'s strides.  The
tensor-core kernel's TMA needs 16-byte aligned pointers and strides.

Beside the kernels: the plain PyTorch version :func:`flash_attention_plain`
(dense masked softmax in f32; CPU tensors run it) and one launch counter
per kernel (``flash_attention_wgmma.launches``,
``flash_attention_simt.launches``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: head dims the CUDA-core kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims the tensor-core kernel takes (bf16 only)
WGMMA_HEAD_DIMS = (64, 128, 256)

#: query rows per block of the CUDA-core / tensor-core kernel, and the
#: CUDA-core kernel's key tile (the tensor-core one's is per head dim)
SIMT_TILE = 64
WGMMA_Q_TILE = 128
WGMMA_KEY_TILE = {64: 128, 128: 128, 256: 64}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FUNCS = {
    "flash_attention_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_WGMMA_FUNCS = {
    "flash_attention_wgmma_fwd": [ctypes.c_void_p] * 7 +
    [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3 +
    [ctypes.c_void_p],
}


def attention_mask(s: int, causal: bool, window: int, device,
                   q_pos: torch.Tensor | None = None,
                   k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """The boolean keep-mask: ``[S, S]`` by index, or ``[B, S, S]`` by the
    int32 ``[B, S]`` positions."""
    if q_pos is None:
        qp = kp = torch.arange(s, device=device)
    else:
        qp, kp = q_pos.long(), k_pos.long()
    qp, kp = qp[..., :, None], kp[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          q_pos: torch.Tensor | None = None,
                          k_pos: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """q ``[B, H, S, D]``, k/v ``[B, KV, S, D]`` -> ``[B, H, S, D]`` in
    q's dtype: scores ``q · k · (1/√D)`` in f32, the index mask (or the
    position mask of ``q_pos``/``k_pos`` ``[B, S]``), softmax, fully
    masked rows set to 0, then ``· v`` in f32.  GQA by reshaping the query
    heads into ``[KV, group]`` (no repeat of k/v)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qf = q.float().reshape(b, kvh, h // kvh, s, d)
    scores = qf @ k.float()[:, :, None].transpose(-1, -2)
    scores.mul_(1.0 / math.sqrt(d))
    mask = attention_mask(s, causal, window, q.device, q_pos, k_pos)
    if mask.dim() == 3:
        mask = mask[:, None, None]
    scores.masked_fill_(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    del scores
    probs.nan_to_num_(0.0)                     # fully masked rows
    out = probs @ v.float()[:, :, None]
    return out.reshape(b, h, s, d).to(q.dtype)


def position_key_ranges(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        causal: bool, window: int, q_tile: int,
                        key_tile: int) -> torch.Tensor:
    """int32 ``[B, ceil(S / q_tile), 4]``: for each query tile, the key
    range ``[lo, hi)`` (``lo`` a multiple of ``key_tile``) outside which
    every key is masked for every query of the tile, and inside it the
    run of whole key tiles ``[full_lo, full_hi)`` in which no key is
    masked for any query of the tile (empty when ``full_lo == full_hi``).
    Both follow from the tiles' position extremes: a key tile is left out
    when ``min k_pos > max q_pos`` (causal) or ``max k_pos <= min q_pos −
    window``; it is whole when ``max k_pos <= min q_pos`` (causal), ``min
    k_pos > max q_pos − window`` and it ends inside ``S``.  The kernels
    walk ``[lo, hi)`` and mask by position the tiles outside the whole
    run.  A query tile with no live key gets one key tile, all masked."""
    b, s = q_pos.shape
    big = 1 << 40

    def extremes(pos, tile):
        n = -(-s // tile)
        pad = n * tile - s
        p = pos.long()
        hi = torch.nn.functional.pad(p, (0, pad), value=-big)
        lo = torch.nn.functional.pad(p, (0, pad), value=big)
        return lo.reshape(b, n, tile).amin(-1), hi.reshape(b, n, tile) \
            .amax(-1), n

    q_min, q_max, _ = extremes(q_pos, q_tile)
    k_min, k_max, nk = extremes(k_pos, key_tile)
    shape = (b, q_min.shape[1], nk)
    live = torch.ones(shape, dtype=torch.bool, device=q_pos.device)
    t = torch.arange(nk, device=q_pos.device)
    whole = ((t + 1) * key_tile <= s).expand(shape).clone()
    if causal:
        live &= k_min[:, None, :] <= q_max[:, :, None]
        whole &= k_max[:, None, :] <= q_min[:, :, None]
    if window > 0:
        live &= k_max[:, None, :] > q_min[:, :, None] - window
        whole &= k_min[:, None, :] > q_max[:, :, None] - window
    lo = torch.where(live, t, nk).amin(-1)
    hi = torch.where(live, t + 1, 0).amax(-1)
    empty = hi <= lo
    lo = torch.where(empty, 0, lo)
    hi = torch.where(empty, 1, hi)
    # the first run of whole tiles (inside [lo, hi): whole tiles are live)
    f_lo = torch.where(whole, t, nk).amin(-1)
    f_hi = torch.where(~whole & (t >= f_lo[..., None]), t, nk).amin(-1)
    none = f_lo >= nk
    f_lo = torch.where(none, 0, f_lo)
    f_hi = torch.where(none, 0, f_hi)
    return torch.stack([lo * key_tile, (hi * key_tile).clamp(max=s),
                        f_lo * key_tile, f_hi * key_tile],
                       -1).to(torch.int32).contiguous()


def _key_ranges(q_pos, k_pos, causal, window, q_tile, key_tile):
    """:func:`position_key_ranges`, computed once per positions tensor:
    the table rides on ``q_pos`` (keyed by ``k_pos``, both tensors'
    versions, the mask and the tiles), so a prefill that hands the same
    positions to every layer builds it once rather than in each of them
    (a few dozen small launches a call)."""
    key = (k_pos.data_ptr(), q_pos._version, k_pos._version, bool(causal),
           int(window), q_tile, key_tile)
    memo = getattr(q_pos, "_flash_key_ranges", None)
    if memo is None or memo[0] != key:
        memo = (key, position_key_ranges(q_pos, k_pos, causal, window,
                                         q_tile, key_tile))
        q_pos._flash_key_ranges = memo
    return memo[1]


def _check(q, k, v):
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention needs q/k/v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention needs q [B, H, S, D] and k/v "
                         f"[B, KV, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or \
            h % k.shape[1] != 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (KV must divide H)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {arg} must be a CUDA "
                             f"tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError("flash_attention: tensors on different "
                             "devices")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {arg}'s last dim must be "
                             f"contiguous (stride 1)")


def _check_positions(q, q_pos, k_pos):
    if (q_pos is None) != (k_pos is None):
        raise ValueError("flash_attention: pass both q_pos and k_pos, or "
                         "neither")
    if q_pos is None:
        return
    want = (q.shape[0], q.shape[2])
    for arg, t in (("q_pos", q_pos), ("k_pos", k_pos)):
        if t.dtype != torch.int32 or tuple(t.shape) != want or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {arg} must be a contiguous "
                             f"int32 [B, S] = {list(want)} tensor on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """Which kernel :func:`flash_attention` launches: ``"wgmma"`` (tensor
    cores) for bf16 at ``d`` in :data:`WGMMA_HEAD_DIMS`, else ``"simt"``
    (CUDA cores)."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "simt"


def _launch_args(q, k, v, out, causal, window, q_pos=None, k_pos=None,
                 ranges=None):
    """The C entry's arguments after the dtype: pointers (positions and
    key ranges 0 for the index mask), sizes, strides, mask, device and
    stream."""
    b, h, s, d = q.shape
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    pos = (0, 0, 0) if q_pos is None else \
        (q_pos.data_ptr(), k_pos.data_ptr(), ranges.data_ptr())
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *pos,
            b, h, k.shape[1], s, d, *strides, int(causal), int(window),
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         q_pos: torch.Tensor | None = None,
                         k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA-core kernel: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``, all
    f32 or all bf16, each with a contiguous last dim (other strides free),
    optional int32 ``[B, S]`` positions -> ``[B, H, S, D]`` in q's dtype,
    laid out like q."""
    _check(q, k, v)
    _check_positions(q, q_pos, k_pos)
    out = torch.empty_like(q)                  # q's strides
    if out.numel() == 0:
        return out
    ranges = None if q_pos is None else _key_ranges(
        q_pos, k_pos, causal, window, SIMT_TILE, SIMT_TILE)
    lib = _build.library("flash_attention", _FUNCS)
    args = _launch_args(q, k, v, out, causal, window, q_pos, k_pos, ranges)
    _build.check(lib.flash_attention_fwd(*args[:7], _DTYPE_CODE[q.dtype],
                                         *args[7:]), "flash_attention_simt")
    flash_attention_simt.launches += 1
    return out


flash_attention_simt.launches = 0


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          q_pos: torch.Tensor | None = None,
                          k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor-core kernel: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``,
    all bf16 with ``D`` in :data:`WGMMA_HEAD_DIMS`, a contiguous last dim
    and 16-byte aligned pointers and strides, optional int32 ``[B, S]``
    positions -> ``[B, H, S, D]`` bf16, laid out like q."""
    _check(q, k, v)
    _check_positions(q, q_pos, k_pos)
    d = q.shape[-1]
    if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention_wgmma takes bf16 at head dims "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype} at {d}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st % 8 for n, st in
                                    zip(t.shape[:3], t.stride()[:3])
                                    if n > 1):
            raise ValueError(f"flash_attention_wgmma: {arg} needs a "
                             f"16-byte aligned pointer and strides (TMA), "
                             f"got strides {t.stride()}")
    out = torch.empty_like(q)                  # q's strides
    if out.numel() == 0:
        return out
    ranges = None if q_pos is None else _key_ranges(
        q_pos, k_pos, causal, window, WGMMA_Q_TILE, WGMMA_KEY_TILE[d])
    lib = _build.library("flash_attention_wgmma", _WGMMA_FUNCS)
    _build.check(lib.flash_attention_wgmma_fwd(
        *_launch_args(q, k, v, out, causal, window, q_pos, k_pos, ranges)),
        "flash_attention_wgmma")
    flash_attention_wgmma.launches += 1
    return out


flash_attention_wgmma.launches = 0

_KERNELS = {"wgmma": flash_attention_wgmma, "simt": flash_attention_simt}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_pos: torch.Tensor | None = None,
                    k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA flash attention: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``,
    all f32 or all bf16, each with a contiguous last dim, optional int32
    ``[B, S]`` positions -> ``[B, H, S, D]`` in q's dtype, laid out like
    q; launches the kernel that :func:`kernel_for` names."""
    _check(q, k, v)
    return _KERNELS[kernel_for(q.dtype, q.shape[-1])](q, k, v, causal, window,
                                                      q_pos, k_pos)
