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

Three CUDA kernels replace ``repro/kernels/flash_attention.py::
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
* :func:`flash_attention_mma` (``csrc/flash_attention_mma.cu``) for bf16
  at ``D ∈ {16, 32}`` (too narrow for wgmma's 64-column boxes; the SMOKE
  configs have these widths but serve in f32, and no shipped config
  serves bf16 at them): ``mma.sync`` m16n8k16 for both products, K/V tiles
  through a ``cp.async`` ring, fragments by ``ldmatrix``, the same single
  rounding of P.
* :func:`flash_attention_simt` (``csrc/flash_attention.cu``) for f32 at
  every head dim: exact f32 FMA on the CUDA cores, K/V tiles through a
  ``cp.async`` ring, a register micro-tile of 8 query rows per thread,
  P passed through each warp's own shared memory.

All three compute the same function: f32 ``m``/``l``/accumulators, key
tiles wholly outside the causal or window band skipped, keys past ``S``
masked (any length runs; the Pallas kernel asserts ``S % 128 == 0``),
masks from indices as in the Pallas kernel and ``chunked_sdpa``, the
longest query tiles launched first.  Under positions the mask need not be
lower-triangular in index (left padding repeats a position), so
index-based tile skipping would be wrong: the wrapper computes, per query
tile, the key range outside which the tiles' position extremes prove
every key masked, and the run of tiles inside it that they prove wholly
unmasked (:func:`position_key_ranges`, at each kernel's own tiles); the
kernel walks the range and masks by position the tiles outside that run.
This is a dispatch, not a fallback: each kernel refuses the dtype and
head dims of the others, and a failed build or launch raises.

Layout: the public function keeps the JAX layout ``[B, H, S, D]``, but
takes strided views — the model passes ``[B, S, H, D]`` tensors through
``transpose(1, 2)`` and the kernels read them in place through their
strides (no transpose copy); the output has ``q``'s strides.  All three
load 16-byte pieces (TMA or ``cp.async``), so they need 16-byte aligned
pointers and strides.

Beside the kernels: the plain PyTorch version :func:`flash_attention_plain`
(dense masked softmax in f32; CPU tensors run it) and one launch counter
per kernel (``flash_attention_wgmma.launches``,
``flash_attention_mma.launches``, ``flash_attention_simt.launches``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.layout import unflatten

#: head dims every kernel is instantiated for: the CUDA-core kernel (f32)
#: takes all of them
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims the bf16 tensor-core kernels take: wgmma and mma.sync
WGMMA_HEAD_DIMS = (64, 128, 256)
MMA_HEAD_DIMS = (16, 32)

#: (query rows, keys) of a block's tiles, per kernel and head dim: the
#: tiles the position key ranges are built at (the CUDA sources' own;
#: ``kernel_config`` reads them back from a built library)
SIMT_TILES = {16: (128, 64), 32: (128, 64), 64: (128, 64), 128: (64, 32),
              256: (64, 32)}
WGMMA_Q_TILE = 128
WGMMA_KEY_TILE = {64: 128, 128: 128, 256: 64}
MMA_TILES = (64, 128)

_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
    [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_CONFIG_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
#: library, C entry point and config entry point of each kernel
_LIBS = {"simt": ("flash_attention", "flash_attention_fwd",
                  "flash_attention_simt_config"),
         "mma": ("flash_attention_mma", "flash_attention_mma_fwd",
                 "flash_attention_mma_config"),
         "wgmma": ("flash_attention_wgmma", "flash_attention_wgmma_fwd",
                   None)}
_DTYPES = (torch.float32, torch.bfloat16)


def attention_mask(s: int, causal: bool, window: int, device,
                   q_pos: torch.Tensor | None = None,
                   k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """The boolean keep-mask: ``[S, S]`` by index, or ``[B, S, S]`` by the
    int32 ``[B, S]`` positions.  Built from the comparisons, not written
    into a fresh buffer: positions on a mesh (``DTensor``) give the mask
    their own layout."""
    if q_pos is None:
        qp = kp = torch.arange(s, device=device)
    else:
        qp, kp = q_pos.long(), k_pos.long()
    qp, kp = qp[..., :, None], kp[..., None, :]
    mask = kp <= qp if causal else None
    if window > 0:
        inside = kp > qp - window
        mask = inside if mask is None else mask & inside
    if mask is None:
        mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                          dtype=torch.bool, device=device)
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
    qf = unflatten(q.float(), 1, (kvh, h // kvh))
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention needs q/k/v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"flash_attention needs q [B, H, S, D] and k/v "
                         f"[B, KV, S, D], got {tuple(qs)}, {tuple(ks)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = qs
    if ks[0] != b or ks[2] != s or ks[3] != d or h % ks[1] != 0:
        raise ValueError(f"flash_attention: k/v {tuple(ks)} do not "
                         f"match q {tuple(qs)} (KV must divide H)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {arg} must be a CUDA "
                             f"tensor, got {t.device}")
        if t.get_device() != q.get_device():
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
    """Which kernel :func:`flash_attention` launches: ``"wgmma"`` for bf16
    at ``d`` in :data:`WGMMA_HEAD_DIMS`, ``"mma"`` for bf16 at ``d`` in
    :data:`MMA_HEAD_DIMS` (both tensor cores), ``"simt"`` (CUDA cores)
    for f32."""
    if dtype == torch.bfloat16:
        return "wgmma" if d in WGMMA_HEAD_DIMS else "mma"
    return "simt"


def _tiles(kind: str, d: int) -> tuple[int, int]:
    """(query rows, keys) of one block's tiles of kernel ``kind`` at head
    dim ``d``."""
    if kind == "simt":
        return SIMT_TILES[d]
    if kind == "mma":
        return MMA_TILES
    return WGMMA_Q_TILE, WGMMA_KEY_TILE[d]


def _library(kind: str):
    name, fwd, cfg = _LIBS[kind]
    funcs = {fwd: _FWD_ARGS}
    if cfg is not None:
        funcs[cfg] = _CONFIG_ARGS
    return _build.library(name, funcs)


def kernel_config(kind: str, d: int, device=None) -> dict:
    """The built ``"simt"`` or ``"mma"`` kernel's tiling at head dim ``d``,
    as its library reports it on ``device``: query and key tile, threads
    and shared bytes a block, and the blocks an SM holds at once."""
    device = torch.device("cuda" if device is None else device)
    out = (ctypes.c_int * 5)()
    lib = _library(kind)
    _build.check(getattr(lib, _LIBS[kind][2])(
        d, device.index or 0, ctypes.addressof(out)), f"{kind} config")
    return dict(zip(("q_tile", "key_tile", "threads", "smem_bytes",
                     "blocks_per_sm"), out))


def _run(kind: str, q, k, v, causal, window, q_pos, k_pos):
    """Launch kernel ``kind`` after the checks every kernel shares: the
    positions, and 16-byte aligned pointers and strides (its loads move
    16-byte pieces); count the launch.  Returns the output, laid out like
    q."""
    _check_positions(q, q_pos, k_pos)
    elems = 16 // q.element_size()
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st % elems for n, st in
                                    zip(t.shape[:3], t.stride()[:3])
                                    if n > 1):
            raise ValueError(f"flash_attention_{kind}: {arg} needs a "
                             f"16-byte aligned pointer and strides, got "
                             f"strides {t.stride()}")
    out = torch.empty_like(q)                  # q's strides
    if out.numel() == 0:
        return out
    ranges = None if q_pos is None else _key_ranges(
        q_pos, k_pos, causal, window, *_tiles(kind, q.shape[-1]))
    _build.check(getattr(_library(kind), _LIBS[kind][1])(*_launch_args(
        q, k, v, out, causal, window, q_pos, k_pos, ranges)),
        f"flash_attention_{kind}")
    _KERNELS[kind].launches += 1
    return out


def _launch_args(q, k, v, out, causal, window, q_pos=None, k_pos=None,
                 ranges=None):
    """A C entry's arguments (every kernel's is the same): pointers
    (positions and key ranges 0 for the index mask), sizes, strides,
    mask, device and stream."""
    b, h, s, d = q.shape
    pos = (0, 0, 0) if q_pos is None else \
        (q_pos.data_ptr(), k_pos.data_ptr(), ranges.data_ptr())
    dev = q.get_device()
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *pos,
            b, h, k.shape[1], s, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], int(causal), int(window),
            dev, torch._C._cuda_getCurrentRawStream(dev))


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         q_pos: torch.Tensor | None = None,
                         k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA-core kernel: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``, all
    f32 with ``D`` in :data:`HEAD_DIMS`, a contiguous last dim and 16-byte
    aligned pointers and strides, optional int32 ``[B, S]`` positions ->
    ``[B, H, S, D]`` f32, laid out like q."""
    _check(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention_simt takes float32, got "
                         f"{q.dtype} (bf16 runs on the tensor cores)")
    return _run("simt", q, k, v, causal, window, q_pos, k_pos)


flash_attention_simt.launches = 0


def flash_attention_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_pos: torch.Tensor | None = None,
                        k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """The narrow-head tensor-core kernel: q ``[B, H, S, D]``, k/v ``[B,
    KV, S, D]``, all bf16 with ``D`` in :data:`MMA_HEAD_DIMS`, a contiguous
    last dim and 16-byte aligned pointers and strides, optional int32
    ``[B, S]`` positions -> ``[B, H, S, D]`` bf16, laid out like q."""
    _check(q, k, v)
    d = q.shape[-1]
    if q.dtype != torch.bfloat16 or d not in MMA_HEAD_DIMS:
        raise ValueError(f"flash_attention_mma takes bf16 at head dims "
                         f"{MMA_HEAD_DIMS}, got {q.dtype} at {d}")
    return _run("mma", q, k, v, causal, window, q_pos, k_pos)


flash_attention_mma.launches = 0


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          q_pos: torch.Tensor | None = None,
                          k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor-core kernel: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``,
    all bf16 with ``D`` in :data:`WGMMA_HEAD_DIMS`, a contiguous last dim
    and 16-byte aligned pointers and strides (TMA), optional int32 ``[B,
    S]`` positions -> ``[B, H, S, D]`` bf16, laid out like q."""
    _check(q, k, v)
    d = q.shape[-1]
    if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention_wgmma takes bf16 at head dims "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype} at {d}")
    return _run("wgmma", q, k, v, causal, window, q_pos, k_pos)


flash_attention_wgmma.launches = 0

_KERNELS = {"wgmma": flash_attention_wgmma, "mma": flash_attention_mma,
            "simt": flash_attention_simt}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_pos: torch.Tensor | None = None,
                    k_pos: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA flash attention: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``,
    all f32 or all bf16, each with a contiguous last dim, optional int32
    ``[B, S]`` positions -> ``[B, H, S, D]`` in q's dtype, laid out like
    q; launches the kernel that :func:`kernel_for` names."""
    _check(q, k, v)
    return _run(kernel_for(q.dtype, q.shape[-1]), q, k, v, causal, window,
                q_pos, k_pos)
