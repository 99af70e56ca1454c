"""Flash attention — causal / sliding-window, GQA — on Hopper.

``out[b, h, i] = Σ_j softmax_j(q_i · k_j / √D) v_j`` over the keys ``j``
that the mask keeps (``j ≤ i`` when causal, ``j > i − window`` when a
window is set), with query head ``h`` reading KV head ``h // group``.
Rows whose every key is masked give 0, as ``ref.mha_reference`` does.

Kernel (CUDA C++, ``csrc/flash_attention.cu``, built for ``sm_90a``):
:func:`flash_attention` replaces ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``, the ``pl.pallas_call`` at
``flash_attention.py:108``).

What bounds it on the card: operations — at granite's prefill shape the
products are 1.4e11 flops against 84 MB moved.  Design, a first simple
one: one block per (query tile of 64 rows, head, batch); 64-key K/V tiles
pass through shared memory as f32; scores, the online-softmax ``m``/``l``
and the output accumulators stay f32 in registers (FMA on the CUDA cores,
no tensor cores yet); key tiles wholly outside the causal or window mask
are never visited; keys past ``S`` are masked, so any length runs (the
Pallas kernel asserts ``S % 128 == 0``).  Masks come from indices, as in
the Pallas kernel and ``chunked_sdpa``.

Layout: the public function keeps the JAX layout ``[B, H, S, D]``, but
takes strided views — the model passes ``[B, S, H, D]`` tensors through
``transpose(1, 2)`` and the kernel reads them in place through their
strides (no transpose copy); the output has ``q``'s strides.

Beside the kernel: its plain PyTorch version :func:`flash_attention_plain`
(dense masked softmax in f32; CPU tensors run it) and a launch counter
(``flash_attention.launches``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FUNCS = {
    "flash_attention_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """q ``[B, H, S, D]``, k/v ``[B, KV, S, D]`` -> ``[B, H, S, D]`` in
    q's dtype: scores ``q · k · (1/√D)`` in f32, the index mask, softmax,
    fully masked rows set to 0, then ``· v`` in f32.  GQA by reshaping the
    query heads into ``[KV, group]`` (no repeat of k/v)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qf = q.float().reshape(b, kvh, h // kvh, s, d)
    scores = qf @ k.float()[:, :, None].transpose(-1, -2)
    scores.mul_(1.0 / math.sqrt(d))
    idx = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[None, :] <= idx[:, None]
    if window > 0:
        mask &= idx[None, :] > idx[:, None] - window
    scores.masked_fill_(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    del scores
    probs.nan_to_num_(0.0)                     # fully masked rows
    out = probs @ v.float()[:, :, None]
    return out.reshape(b, h, s, d).to(q.dtype)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """CUDA flash attention: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``,
    all f32 or all bf16, each with a contiguous last dim (other strides
    free) -> ``[B, H, S, D]`` in q's dtype, laid out like q."""
    _check(q, k, v)
    b, h, s, d = q.shape
    kvh = k.shape[1]
    out = torch.empty_like(q)                  # q's strides
    if out.numel() == 0:
        return out
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    lib = _build.library("flash_attention", _FUNCS)
    _build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, kvh, s, d, *strides, int(causal),
        int(window), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
