"""ELLPACK SpMM — GNN neighbour aggregation — on Hopper.

``out[q, i] = Σ_k w[q, i, k] · x[q, nbr[q, i, k]]`` over degree-padded
neighbour lists (pad slots carry ``w == 0``), accumulated in f32 with ``k``
ascending.

Kernel (CUDA C++, ``csrc/ell_spmm.cu``, built for ``sm_90a``):
:func:`ell_spmm` replaces ``repro/kernels/ell_spmm.py::ell_spmm``
(``_ell_kernel``, the ``pl.pallas_call`` at ``ell_spmm.py:78``).

What bounds it on the card: device-memory bytes — two flops per gathered
f32 against 4 bytes read, counting each referenced ``x`` row once.  But
each row of ``x`` is gathered once per edge that reads it (about 8 times
on the GNN path), so the bound is within reach only while the rows being
gathered stay on chip; one partition's ``x`` slab (45.5 MB at F = 256)
is about the whole 50 MB L2.  The TPU kernel kept its gathers in fast
memory by streaming source chunks through VMEM; here the output is cut
into tiles of (partition, column slice of 128, row tile), walked
slice-major by a persistent grid whose blocks take the next tile from a
counter (zeroed here, per call), so the blocks in flight gather from one
partition's column slice of ``x``.  The gathers carry an L2
``evict_last`` policy and ``out`` is written with streaming stores, per
instruction (nothing device-wide is set).  A half-warp owns a row with
two 16-byte loads per neighbour; the row's ids and weights are loaded
once per slice and broadcast by warp shuffles, the neighbour loop stops
at the warp's last valid slot, and four gathers issue before their FMAs.
A leading partition dimension ``Q`` lets one launch cover every partition
(the JAX package vmaps over them).  Widths off the float4 grid, or a
misaligned ``x``, take the same raster with a full warp of 4-byte loads.
``scripts/ell_spmm_variants.py`` measures the design's choices.

Beside the kernel: its plain PyTorch version :func:`ell_spmm_plain` (the
k-ascending loop of ``repro/kernels/ops.py::_ell_cpu``; CPU tensors run
it) and a launch counter (``ell_spmm.launches``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FUNCS = {
    "ell_spmm_f32": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 5 +
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def ell_spmm_plain(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor
                   ) -> torch.Tensor:
    """x ``[Q, Ns, F]``, nbr/w ``[Q, Nd, K]`` -> ``[Q, Nd, F]``:
    ``acc += w[..., k] · x[nbr[..., k]]`` for ``k`` ascending, in f32."""
    q, n_src, f = x.shape
    _, n_dst, k = nbr.shape
    xf = x.reshape(q * n_src, f).float()
    off = (torch.arange(q, device=x.device) * n_src)[:, None]
    acc = torch.zeros((q, n_dst, f), dtype=torch.float32, device=x.device)
    for kk in range(k):
        rows = (nbr[:, :, kk].long() + off).reshape(-1)
        acc = acc + w[:, :, kk, None].float() * \
            xf.index_select(0, rows).reshape(q, n_dst, f)
    return acc.to(x.dtype)


def ell_spmm(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """CUDA ELL SpMM: x ``[Q, Ns, F]`` f32, nbr ``[Q, Nd, K]`` int32, w
    ``[Q, Nd, K]`` f32 -> ``[Q, Nd, F]`` f32.  Neighbour ids outside
    ``[0, Ns)`` contribute nothing."""
    if x.dtype != torch.float32 or w.dtype != torch.float32 or \
            nbr.dtype != torch.int32:
        raise TypeError(f"ell_spmm needs f32 x/w and int32 nbr, got "
                        f"{x.dtype}, {w.dtype}, {nbr.dtype}")
    if x.dim() != 3 or nbr.dim() != 3 or nbr.shape != w.shape or \
            nbr.shape[0] != x.shape[0]:
        raise ValueError(f"ell_spmm needs x [Q, Ns, F] and nbr/w [Q, Nd, K],"
                         f" got {tuple(x.shape)}, {tuple(nbr.shape)}, "
                         f"{tuple(w.shape)}")
    for arg, t in (("x", x), ("nbr", nbr), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"ell_spmm: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ell_spmm: {arg} must be contiguous")
        if t.device != x.device:
            raise ValueError("ell_spmm: tensors on different devices")
    q, n_src, f = x.shape
    _, n_dst, k = nbr.shape
    out = torch.empty((q, n_dst, f), dtype=torch.float32, device=x.device)
    vec4 = int(f % 4 == 0 and x.data_ptr() % 16 == 0)
    lib = _build.library("ell_spmm", _FUNCS)
    counter = torch.zeros(1, dtype=torch.int32, device=x.device)  # tiles
    _build.check(lib.ell_spmm_f32(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
        counter.data_ptr(), q, n_dst, n_src, k, f, vec4, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream), "ell_spmm")
    ell_spmm.launches += 1
    return out


ell_spmm.launches = 0
