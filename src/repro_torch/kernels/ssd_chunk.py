"""Mamba2 SSD intra-chunk quadratic form — on Hopper.

For each (batch, chunk, head), with ``g = h // (H / G)`` the head's group:

    M[t, s]  = (C_t · B_s) · exp(cum_t − cum_s) · dt_s · 1[s ≤ t]
    Y_intra  = M @ X                                  [Q, P]
    S_contrib = Xᵀ @ (exp(cum_end − cum) · dt · B)     [P, N]

Kernel (CUDA C++, ``csrc/ssd_chunk.cu``, built for ``sm_90a``):
:func:`ssd_chunk` replaces ``repro/kernels/ssd_chunk.py::ssd_chunk``
(``_ssd_chunk_kernel``, the ``pl.pallas_call`` at ``ssd_chunk.py:77``).
It computes the Pallas kernel's function over group-expanded inputs, but
reads B and C un-expanded ``[B, NC, Q, G, N]``: at mamba2's shape (24
heads, one group) the expansion would read 24× their bytes.

What bounds it on the card: f32 operations on the CUDA cores (13.45
GFLOP of needed work against 0.27 GB at mamba2's prefill shape).  ``C ·
Bᵀ`` depends on the group only, so the ``Y`` pass forms it once per (64-
row t tile, group, batch·chunk) into shared memory — over the causal
``s`` range only — and shares it across the group's heads, where a
per-head design repeats it 24 times at mamba2's shape (half the old
kernel's arithmetic).  Per head it builds ``M = G ∘ exp(cum_t − cum_s) ∘
dt_s`` (``exp`` only where ``s ≤ t``: above the diagonal it could
overflow) and accumulates ``M · X_h`` with 4 × 8 register tiles, while
``cp.async`` brings the next X tile; t tiles run longest first.  The
state contribution is a second launch in the same call: each block loads
a q tile of B once for two heads.  Any ``Q`` up to :data:`MAX_Q` runs
(tiles past it are masked; the shared ``G`` tile grows with ``Q``).
Inputs are strided views with the last dim contiguous, so the model's
conv output is read in place.

Beside the kernel: its plain PyTorch version :func:`ssd_chunk_plain` (the
chunk math of ``repro/models/mamba2.py::ssd_chunked``; CPU tensors run
it) and a launch counter (``ssd_chunk.launches``; one per call, which
launches both passes).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_VIEW = [ctypes.c_void_p] + [ctypes.c_longlong] * 4
_FUNCS = {
    "ssd_chunk_f32": _VIEW * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 +
    [ctypes.c_int, ctypes.c_void_p],
}
#: largest d_state / head_dim the kernel's shared-memory tiles take
MAX_N = 256
MAX_P = 256
#: longest chunk the kernel's shared C·Bᵀ tile holds
MAX_Q = 448


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, NC, Q, H, P]``, dt/cum ``[B, NC, Q, H]``, b/c ``[B, NC, Q,
    G, N]`` -> (y_intra ``[B, NC, Q, H, P]``, state_contrib ``[B, NC, H,
    P, N]``), both f32, term for term the chunk math of ``ssd_chunked``
    (B and C repeated to the heads here, in the plain version only)."""
    rep = x.shape[3] // b.shape[3]
    q = x.shape[2]
    xf, dtf, cumf = x.float(), dt.float(), cum.float()
    bg = b.float().repeat_interleave(rep, dim=3)
    cg = c.float().repeat_interleave(rep, dim=3)
    scores = torch.einsum("bnqhk,bnshk->bnqsh", cg, bg)
    seg = cumf[:, :, :, None, :] - cumf[:, :, None, :, :]   # cum_t - cum_s
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = seg.masked_fill(~causal[None, None, :, :, None],
                            float("-inf")).exp()
    m = scores * decay * dtf[:, :, None, :, :]
    y = torch.einsum("bnqsh,bnshp->bnqhp", m, xf)
    w = torch.exp(cumf[:, :, -1:, :] - cumf) * dtf             # [B,NC,Q,H]
    s = torch.einsum("bnqhk,bnqhp->bnhpk", bg * w[..., None], xf)
    return y, s


def _view(t: torch.Tensor) -> list:
    return [t.data_ptr(), *t.stride()[:4]]


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA SSD intra-chunk form: x ``[B, NC, Q, H, P]``, dt/cum ``[B,
    NC, Q, H]``, b/c ``[B, NC, Q, G, N]`` (G divides H), all f32 CUDA
    tensors with a contiguous last dim -> (y ``[B, NC, Q, H, P]``, s
    ``[B, NC, H, P, N]``), f32 and contiguous."""
    for arg, t in (("x", x), ("dt", dt), ("cum", cum), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk needs f32 inputs, got {arg} "
                            f"{t.dtype}")
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_chunk: {arg} must be a CUDA tensor on "
                             f"x's device, got {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunk: {arg}'s last dim must be "
                             f"contiguous")
    if x.dim() != 5 or dt.shape != x.shape[:4] or cum.shape != dt.shape or \
            b.dim() != 5 or b.shape != c.shape or b.shape[:3] != x.shape[:3] \
            or x.shape[3] % b.shape[3] != 0:
        raise ValueError(f"ssd_chunk needs x [B, NC, Q, H, P], dt/cum [B, "
                         f"NC, Q, H], b/c [B, NC, Q, G, N] with G | H; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(cum.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    if n % 4 or p % 4 or n > MAX_N or p > MAX_P:
        raise ValueError(f"ssd_chunk: d_state {n} and head_dim {p} must be "
                         f"multiples of 4 up to {MAX_N} / {MAX_P}")
    if q > MAX_Q:
        raise ValueError(f"ssd_chunk: chunk length {q} exceeds {MAX_Q}")
    y = torch.empty((bsz, nc, q, h, p), dtype=torch.float32, device=x.device)
    s = torch.empty((bsz, nc, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, s
    # (pointer, strides of the first four dims) each; for dt/cum the
    # fourth is the contiguous head dim
    views = _view(x) + _view(dt) + _view(cum) + _view(b) + _view(c)
    lib = _build.library("ssd_chunk", _FUNCS)
    _build.check(lib.ssd_chunk_f32(
        *views, y.data_ptr(), s.data_ptr(), bsz, nc, q, h, p, g, n,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream),
        "ssd_chunk")
    ssd_chunk.launches += 1
    return y, s


ssd_chunk.launches = 0
