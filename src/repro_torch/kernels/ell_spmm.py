"""ELLPACK SpMM — GNN neighbour aggregation — on Hopper.

``out[q, i] = Σ_k w[q, i, k] · x[q, nbr[q, i, k]]`` over degree-padded
neighbour lists (pad slots carry ``w == 0``), accumulated in f32 with ``k``
ascending.

Kernel (CUDA C++, ``csrc/ell_spmm.cu``, built for ``sm_90a``):
:func:`ell_spmm` replaces ``repro/kernels/ell_spmm.py::ell_spmm``
(``_ell_kernel``, the ``pl.pallas_call`` at ``ell_spmm.py:78``).

What bounds it on the card: device-memory bytes — two flops per gathered
f32 against 4 bytes read.  Design: the TPU kernel streams source chunks of
``x`` through VMEM (and ``ops.py`` pads rows to its grid); on Hopper the
gathers go straight to device memory through L2, so there is no source
chunking and no row padding.  One warp per destination row: the row's
neighbour ids and weights are loaded once (one per lane) and broadcast by
warp shuffles, lanes span the feature dimension with 16-byte loads, pad
slots skip their gather, and a leading partition dimension ``Q`` lets one
launch cover every partition (the JAX package vmaps over them).

Beside the kernel: its plain PyTorch version :func:`ell_spmm_plain` (the
k-ascending loop of ``repro/kernels/ops.py::_ell_cpu``; CPU tensors run
it) and a launch counter (``ell_spmm.launches``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FUNCS = {
    "ell_spmm_f32": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 5 +
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
    _build.check(lib.ell_spmm_f32(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
        q, n_dst, n_src, k, f, vec4, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream), "ell_spmm")
    ell_spmm.launches += 1
    return out


ell_spmm.launches = 0
