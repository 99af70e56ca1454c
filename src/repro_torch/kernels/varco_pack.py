"""Lane-block pack/unpack — the p2p wire's gather and scatter — on Hopper.

The paper's compression ships a random subset of activation elements
chosen by a shared PRNG.  The runtime subsamples whole **128-lane feature
blocks**: the shared key selects ``K`` kept blocks, ``pack`` gathers them
into a dense ``[N, K·128]`` wire buffer and ``unpack`` scatters them back,
zero-filling dropped blocks (the paper's decoder).

Kernels (CUDA C++, ``csrc/varco_pack.cu``, built for ``sm_90a``):

* :func:`varco_pack` replaces ``repro/kernels/varco_pack.py::varco_pack``
  (``_pack_kernel``, the ``pl.pallas_call`` at ``varco_pack.py:66``);
* :func:`varco_unpack` replaces ``repro/kernels/varco_pack.py::
  varco_unpack`` (``_unpack_kernel``, ``varco_pack.py:256``).

What bounds them on the card: device-memory bytes — each is a pure copy
(pack reads and writes ``N·K·128`` floats; unpack reads ``N·K·128`` and
writes ``N·F``).  Design: the TPU steers whole-tile DMAs from
scalar-prefetched indices; here every warp copies one 128-lane block of one
row as 32 coalesced 16-byte loads, each block loads its own ``kept``/``inv``
row, and a leading batch dimension ``Q`` with one index row per sender lets
one launch serve every sender (the JAX package vmaps over them).

The quantised wire fuses the gather with the codec (CUDA C++,
``csrc/varco_pack_quant.cu``):

* :func:`varco_pack_quant` replaces ``repro/kernels/varco_pack.py::
  varco_pack_quant`` (``_pack_quant_kernel``, ``varco_pack.py:158``):
  gather + per-(row, block) amax/scale + round-half-even + clamp +
  sub-byte bit-pack (``8/w`` lanes per byte);
* :func:`varco_unpack_quant` replaces ``varco_pack.py::varco_unpack_quant``
  (``_unpack_quant_kernel``, ``varco_pack.py:213``): bit-unpack +
  sign-extend + ``× scale`` + scatter with zero-fill.

Both are bound by device-memory bytes.  One warp per (batch row, block);
the block amax is a warp shuffle max-reduce and each lane's four levels
fill whole bytes at every width, so the kernels need neither shared
memory nor atomics.  The TPU kernels take one static ``qmax``; here each
batch row (one sender's hop to one receiver) carries its own ``qmax``,
so pairs planned below the storage width share the launch.

:func:`varco_pack_quant_stochastic` is the same kernel with unbiased
stochastic rounding, ``floor(x / scale + u)``, its uniforms ``u`` drawn
in-register from one Threefry key per batch row over the packed ``[N,
K, 128]`` block — bitwise the JAX package's ``quant_levels(wire_pack(x),
w, key=keys[b])``, which the TPU computes around its Pallas kernel in
XLA.  A second template instantiation of the kernel, so the rint code is
unchanged; bound by integer operations (a 20-round hash an element).

Beside each kernel: its plain PyTorch version (``varco_pack_plain``,
``varco_pack_quant_plain``, ``varco_pack_quant_stochastic_plain``, ...;
what CPU tensors run) and a launch counter (``varco_pack.launches``),
bumped only where the kernel is launched.

The mask builders (:func:`block_mask_indices_k`,
:func:`block_mask_indices_pos`, :func:`worker_block_maps`,
:func:`worker_block_maps_pos`) draw from the bitwise port of the JAX key
stream (``repro_torch.prng``), so kept sets equal the JAX package's for
the same key.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import _build
from repro_torch.kernels.randmask import random_uniform_plain

LANE = 128

_FUNCS = {
    "varco_pack_f32": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 +
    [ctypes.c_int, ctypes.c_void_p],
    "varco_unpack_f32": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 +
    [ctypes.c_int, ctypes.c_void_p],
}
_QUANT_FUNCS = {
    "varco_pack_quant_f32": [ctypes.c_void_p] * 6 +
    [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "varco_unpack_quant_f32": [ctypes.c_void_p] * 4 +
    [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
#: sub-byte storage widths of the quantised wire (8/w lanes per byte)
STORE_WIDTHS = (2, 4, 8)


# ---------------------------------------------------------------------------
# Shared-key block masks (host, numpy int32)
# ---------------------------------------------------------------------------


def block_mask_indices(key: np.ndarray, n_blocks: int, rate: float
                       ) -> tuple[np.ndarray, np.ndarray]:
    """``(kept [K] sorted, inv [n_blocks])`` for ``K = max(floor(n_blocks
    / rate), 1)`` kept lane-blocks (never zero payload), drawn from the
    shared key: both ends derive them, so no index crosses the wire."""
    k = max(int(n_blocks / max(rate, 1.0)), 1)
    return block_mask_indices_k(key, n_blocks, k)


def block_mask_indices_k(key: np.ndarray, n_blocks: int, k: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """``(kept [k] sorted, inv [n_blocks])``: the first ``k`` entries of
    the shared permutation, and each block's column in the packed buffer
    (``-1`` if dropped)."""
    kept, inv, _ = block_mask_indices_pos(key, n_blocks, k)
    return kept, inv


def block_mask_indices_pos(key: np.ndarray, n_blocks: int, k: int
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`block_mask_indices_k` plus ``pos [n_blocks]``, each block's
    slot in the shared permutation (kept sets at two counts ``k' <= k``
    are nested: "slot < count")."""
    perm = prng.permutation(key, n_blocks)
    pos = np.zeros(n_blocks, np.int32)
    pos[perm] = np.arange(n_blocks, dtype=np.int32)
    kept = np.sort(perm[:k]).astype(np.int32)
    inv = np.full(n_blocks, -1, np.int32)
    inv[kept] = np.arange(k, dtype=np.int32)
    return kept, inv, pos


def worker_block_maps(key: np.ndarray, q: int, n_blocks: int, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Every worker's ``(kept [Q, k], inv [Q, n_blocks])`` for one
    exchange (the scalar-rate wires' masks)."""
    kept, inv, _ = worker_block_maps_pos(key, q, n_blocks, k)
    return kept, inv


def worker_block_maps_pos(key: np.ndarray, q: int, n_blocks: int, k: int
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every worker's ``(kept [Q, k], inv [Q, n_blocks], pos [Q,
    n_blocks])`` for one exchange: worker ``i`` draws from
    ``fold_in(key, i)`` — the key-stream rule every wire path shares."""
    maps = [block_mask_indices_pos(prng.fold_in(key, i), n_blocks, k)
            for i in range(q)]
    return tuple(np.stack(parts) for parts in zip(*maps))


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors run these; the card checks against them)
# ---------------------------------------------------------------------------


def varco_pack_plain(x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """x ``[Q, N, F]``, kept ``[Q, K]`` -> ``[Q, N, K·128]``."""
    q, n, f = x.shape
    k = kept.shape[-1]
    xb = x.reshape(q, n, f // LANE, LANE)
    idx = kept.long()[:, None, :, None].expand(q, n, k, LANE)
    return torch.gather(xb, 2, idx).reshape(q, n, k * LANE)


def varco_unpack_plain(packed: torch.Tensor, inv: torch.Tensor
                       ) -> torch.Tensor:
    """packed ``[Q, M, K·128]``, inv ``[Q, NB]`` -> ``[Q, M, NB·128]``,
    zero where ``inv < 0``."""
    q, m, kf = packed.shape
    nb = inv.shape[-1]
    pb = packed.reshape(q, m, kf // LANE, LANE)
    idx = inv.long().clamp(min=0)[:, None, :, None].expand(q, m, nb, LANE)
    out = torch.gather(pb, 2, idx)
    live = (inv >= 0)[:, None, :, None]
    return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)
                       ).reshape(q, m, nb * LANE)


def pack_bits_plain(levels: torch.Tensor, width: int) -> torch.Tensor:
    """Bit-pack int-``width`` levels into bytes: int8 ``[..., M]`` ->
    uint8 ``[..., ceil(M / (8/width))]``, ``8/width`` consecutive lanes per
    byte, little-endian within the byte, low ``width`` bits of each two's
    complement.  ``width == 8`` is the identity reinterpret; tail lanes
    are zero-padded into the last byte."""
    if width not in STORE_WIDTHS:
        raise ValueError(f"width must be 2, 4 or 8, got {width}")
    lv = levels.to(torch.int8)
    if width == 8:
        return lv.view(torch.uint8)
    vpb = 8 // width
    pad = (-lv.shape[-1]) % vpb
    if pad:
        lv = torch.nn.functional.pad(lv, (0, pad))
    u = lv.view(torch.uint8) & (2 ** width - 1)
    u = u.reshape(*lv.shape[:-1], -1, vpb)
    out = u[..., 0].clone()
    for j in range(1, vpb):
        out |= u[..., j] << (j * width)
    return out


def unpack_bits_plain(packed: torch.Tensor, width: int,
                      m: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_bits_plain`: uint8 bytes -> sign-extended
    int8 levels (``m`` trims the tail byte's zero-pad lanes)."""
    if width not in STORE_WIDTHS:
        raise ValueError(f"width must be 2, 4 or 8, got {width}")
    if width == 8:
        out = packed.view(torch.int8)
        return out if m is None else out[..., :m]
    vpb = 8 // width
    shifts = torch.arange(vpb, dtype=torch.uint8, device=packed.device) \
        * width
    v = ((packed[..., None] >> shifts) & (2 ** width - 1)).to(torch.int32)
    v = torch.where(v >= 2 ** (width - 1), v - 2 ** width, v)
    out = v.to(torch.int8).reshape(*packed.shape[:-1], -1)
    return out[..., : (m if m is not None else out.shape[-1])]


def _pack_quant_plain(x: torch.Tensor, kept: torch.Tensor,
                      qmax: torch.Tensor, width: int,
                      keys: torch.Tensor | None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    packed = varco_pack_plain(x, kept)
    b, n, kf = packed.shape
    k = kf // LANE
    pb = packed.reshape(b, n, k, LANE)
    qm = qmax.to(torch.float32).reshape(b, 1, 1)
    amax = pb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qm, torch.ones_like(amax))
    v = pb / scale[..., None]
    if keys is None:
        lv = torch.round(v)
    else:
        u = random_uniform_plain(keys, n * kf).reshape(pb.shape)
        lv = torch.floor(v + u)
    lv = torch.minimum(torch.maximum(lv, -qm[..., None]), qm[..., None])
    return pack_bits_plain(lv.to(torch.int8).reshape(b, n, kf), width), scale


def varco_pack_quant_plain(x: torch.Tensor, kept: torch.Tensor,
                           qmax: torch.Tensor, width: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, N, F]``, kept ``[B, K]``, qmax ``[B]`` -> ``(payload uint8
    [B, N, K·128·width/8], scales f32 [B, N, K])``: the kept blocks'
    per-(row, block) symmetric levels ``clamp(round(x / scale), ±qmax)``
    with ``scale = amax / qmax`` (1 for an all-zero block), bit-packed at
    ``width``."""
    return _pack_quant_plain(x, kept, qmax, width, None)


def varco_pack_quant_stochastic_plain(x: torch.Tensor, kept: torch.Tensor,
                                      qmax: torch.Tensor, keys: torch.Tensor,
                                      width: int
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`varco_pack_quant_plain` with stochastic rounding: levels
    ``clamp(floor(x / scale + u), ±qmax)``, ``u[b] = uniform(keys[b],
    [N, K, 128])`` (keys int32 ``[B, 2]``, uint32 bits)."""
    return _pack_quant_plain(x, kept, qmax, width, keys)


def varco_unpack_quant_plain(payload: torch.Tensor, scales: torch.Tensor,
                             inv: torch.Tensor, width: int) -> torch.Tensor:
    """payload uint8 ``[B, N, K·128·width/8]``, scales ``[B, N, K]``, inv
    ``[B, NB]`` -> f32 ``[B, N, NB·128]``: ``level · scale`` scattered back,
    zero where ``inv < 0``."""
    b, n, k = scales.shape
    levels = unpack_bits_plain(payload, width, k * LANE)
    deq = levels.to(torch.float32).reshape(b, n, k, LANE) * scales[..., None]
    return varco_unpack_plain(deq.reshape(b, n, k * LANE), inv)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check_cuda(name: str, **tensors) -> torch.device:
    dev = None
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = t.device
    return dev


def varco_pack(x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """CUDA pack: x ``[Q, N, F]`` f32, kept ``[Q, K]`` int32 -> ``[Q, N,
    K·128]`` (``F % 128 == 0``)."""
    if x.dtype != torch.float32 or kept.dtype != torch.int32:
        raise TypeError(f"varco_pack needs f32 x and int32 kept, got "
                        f"{x.dtype}, {kept.dtype}")
    if x.dim() != 3 or kept.dim() != 2 or kept.shape[0] != x.shape[0] \
            or x.shape[2] % LANE:
        raise ValueError(f"varco_pack needs x [Q, N, F·128] and kept "
                         f"[Q, K], got {tuple(x.shape)}, {tuple(kept.shape)}")
    dev = _check_cuda("varco_pack", x=x, kept=kept)
    q, n, f = x.shape
    k = kept.shape[1]
    out = torch.empty((q, n, k * LANE), dtype=x.dtype, device=dev)
    lib = _build.library("varco_pack", _FUNCS)
    _build.check(lib.varco_pack_f32(
        x.data_ptr(), kept.data_ptr(), out.data_ptr(), q, n, f // LANE, k,
        dev.index, torch.cuda.current_stream(dev).cuda_stream),
        "varco_pack")
    varco_pack.launches += 1
    return out


def varco_unpack(packed: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """CUDA unpack: packed ``[Q, M, K·128]`` f32, inv ``[Q, NB]`` int32 ->
    ``[Q, M, NB·128]``, zero-filling blocks with ``inv < 0``."""
    if packed.dtype != torch.float32 or inv.dtype != torch.int32:
        raise TypeError(f"varco_unpack needs f32 packed and int32 inv, got "
                        f"{packed.dtype}, {inv.dtype}")
    if packed.dim() != 3 or inv.dim() != 2 or \
            inv.shape[0] != packed.shape[0] or packed.shape[2] % LANE:
        raise ValueError(f"varco_unpack needs packed [Q, M, K·128] and inv "
                         f"[Q, NB], got {tuple(packed.shape)}, "
                         f"{tuple(inv.shape)}")
    dev = _check_cuda("varco_unpack", packed=packed, inv=inv)
    q, m, kf = packed.shape
    nb = inv.shape[1]
    out = torch.empty((q, m, nb * LANE), dtype=packed.dtype, device=dev)
    lib = _build.library("varco_pack", _FUNCS)
    _build.check(lib.varco_unpack_f32(
        packed.data_ptr(), inv.data_ptr(), out.data_ptr(), q, m, nb,
        kf // LANE, dev.index, torch.cuda.current_stream(dev).cuda_stream),
        "varco_unpack")
    varco_unpack.launches += 1
    return out


def _launch_pack_quant(name: str, x: torch.Tensor, kept: torch.Tensor,
                       qmax: torch.Tensor, keys: torch.Tensor | None,
                       width: int) -> tuple[torch.Tensor, torch.Tensor]:
    if x.dtype != torch.float32 or kept.dtype != torch.int32 or \
            qmax.dtype != torch.float32:
        raise TypeError(f"{name} needs f32 x/qmax and int32 kept, got "
                        f"{x.dtype}, {qmax.dtype}, {kept.dtype}")
    if width not in STORE_WIDTHS:
        raise ValueError(f"{name} width must be 2, 4 or 8, got {width}")
    if x.dim() != 3 or kept.dim() != 2 or kept.shape[0] != x.shape[0] or \
            qmax.shape != (x.shape[0],) or x.shape[2] % LANE:
        raise ValueError(f"{name} needs x [B, N, F·128], kept [B, K] and "
                         f"qmax [B], got {tuple(x.shape)}, "
                         f"{tuple(kept.shape)}, {tuple(qmax.shape)}")
    tensors = {"x": x, "kept": kept, "qmax": qmax}
    if keys is not None:
        if keys.dtype != torch.int32 or tuple(keys.shape) != (x.shape[0],
                                                              2):
            raise ValueError(f"{name} needs int32 keys [B, 2], got "
                             f"{keys.dtype} {tuple(keys.shape)}")
        tensors["keys"] = keys
    dev = _check_cuda(name, **tensors)
    b, n, f = x.shape
    k = kept.shape[1]
    payload = torch.empty((b, n, k * LANE * width // 8), dtype=torch.uint8,
                          device=dev)
    scales = torch.empty((b, n, k), dtype=torch.float32, device=dev)
    lib = _build.library("varco_pack_quant", _QUANT_FUNCS)
    _build.check(lib.varco_pack_quant_f32(
        x.data_ptr(), kept.data_ptr(), qmax.data_ptr(),
        None if keys is None else keys.data_ptr(), payload.data_ptr(),
        scales.data_ptr(), b, n, f // LANE, k, width, dev.index,
        torch.cuda.current_stream(dev).cuda_stream), name)
    return payload, scales


def varco_pack_quant(x: torch.Tensor, kept: torch.Tensor, qmax: torch.Tensor,
                     width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA fused pack + quantise + bit-pack: x ``[B, N, F]`` f32, kept
    ``[B, K]`` int32, qmax ``[B]`` f32 -> ``(payload uint8 [B, N,
    K·128·width/8], scales f32 [B, N, K])``, ``width`` in {2, 4, 8}."""
    out = _launch_pack_quant("varco_pack_quant", x, kept, qmax, None, width)
    varco_pack_quant.launches += 1
    return out


def varco_pack_quant_stochastic(x: torch.Tensor, kept: torch.Tensor,
                                qmax: torch.Tensor, keys: torch.Tensor,
                                width: int
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA fused pack + quantise + bit-pack with stochastic rounding:
    :func:`varco_pack_quant` plus keys int32 ``[B, 2]`` (uint32 bits, one
    Threefry key per batch row) on the same card."""
    out = _launch_pack_quant("varco_pack_quant_stochastic", x, kept, qmax,
                             keys, width)
    varco_pack_quant_stochastic.launches += 1
    return out


def varco_unpack_quant(payload: torch.Tensor, scales: torch.Tensor,
                       inv: torch.Tensor, width: int) -> torch.Tensor:
    """CUDA fused bit-unpack + dequantise + scatter: payload uint8 ``[B, N,
    K·128·width/8]``, scales f32 ``[B, N, K]``, inv int32 ``[B, NB]`` ->
    f32 ``[B, N, NB·128]``, zero-filling blocks with ``inv < 0``."""
    if payload.dtype != torch.uint8 or scales.dtype != torch.float32 or \
            inv.dtype != torch.int32:
        raise TypeError(f"varco_unpack_quant needs uint8 payload, f32 scales "
                        f"and int32 inv, got {payload.dtype}, {scales.dtype},"
                        f" {inv.dtype}")
    if width not in STORE_WIDTHS:
        raise ValueError(f"varco_unpack_quant width must be 2, 4 or 8, got "
                         f"{width}")
    if payload.dim() != 3 or scales.dim() != 3 or inv.dim() != 2 or \
            scales.shape[:2] != payload.shape[:2] or \
            inv.shape[0] != payload.shape[0] or \
            payload.shape[2] != scales.shape[2] * LANE * width // 8:
        raise ValueError(f"varco_unpack_quant needs payload [B, N, "
                         f"K·128·w/8], scales [B, N, K] and inv [B, NB], got "
                         f"{tuple(payload.shape)}, {tuple(scales.shape)}, "
                         f"{tuple(inv.shape)}")
    dev = _check_cuda("varco_unpack_quant", payload=payload, scales=scales,
                      inv=inv)
    b, n, k = scales.shape
    nb = inv.shape[1]
    out = torch.empty((b, n, nb * LANE), dtype=torch.float32, device=dev)
    lib = _build.library("varco_pack_quant", _QUANT_FUNCS)
    _build.check(lib.varco_unpack_quant_f32(
        payload.data_ptr(), scales.data_ptr(), inv.data_ptr(),
        out.data_ptr(), b, n, nb, k, width, dev.index,
        torch.cuda.current_stream(dev).cuda_stream), "varco_unpack_quant")
    varco_unpack_quant.launches += 1
    return out


varco_pack.launches = 0
varco_unpack.launches = 0
varco_pack_quant.launches = 0
varco_pack_quant_stochastic.launches = 0
varco_unpack_quant.launches = 0
