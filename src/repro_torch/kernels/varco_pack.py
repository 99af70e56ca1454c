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

Beside each kernel: its plain PyTorch version (``varco_pack_plain`` /
``varco_unpack_plain``, what CPU tensors run) and a launch counter
(``varco_pack.launches``), bumped only where the kernel is launched.

The mask builders (:func:`block_mask_indices_k`,
:func:`block_mask_indices_pos`, :func:`worker_block_maps_pos`) draw from
the bitwise port of the JAX key stream (``repro_torch.prng``), so kept
sets equal the JAX package's for the same key.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import _build

LANE = 128

_FUNCS = {
    "varco_pack_f32": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 +
    [ctypes.c_int, ctypes.c_void_p],
    "varco_unpack_f32": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 +
    [ctypes.c_int, ctypes.c_void_p],
}


# ---------------------------------------------------------------------------
# Shared-key block masks (host, numpy int32)
# ---------------------------------------------------------------------------


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


varco_pack.launches = 0
varco_unpack.launches = 0
